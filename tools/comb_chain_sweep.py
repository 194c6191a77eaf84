"""Time the comb rows kernel (csrc/comb.cu ``sp2_comb_rows``) at the main
path's shapes for several first-pass chains k, against another checkout's
``comb_rows`` at the same inputs in the same call.

    python3 tools/comb_chain_sweep.py [--old DIR]

The shapes come from SpartanSNARK on SHA-256 over a 1 KiB preimage (Hyrax
width 2048): the prep's precommitted witness (256 x 2048, the 11-window
table), a mesh rank's half of it (128 rows), [LZ, d_vec] (2 x 2048, 43
windows, random scalars) and 16 blinds over h's table (16 x 1).  With
``--old DIR`` a subprocess imports ``spartan2_tpu_torch`` from DIR and
times its ``comb_rows`` on the same tensors; runs go new, old, new, old.
Every result of the default chain equals the plain version limb for limb;
every other chain's, and the old checkout's, equal it in affine.  Needs one
CUDA card; prints the card's name and power limit, then one JSON object a
line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tools._timing import card_line  # noqa: E402
WORK = ROOT / "build" / "comb_sweep"
CHAINS = {"witness": (2, 4, 8, 16, 32), "shard": (2, 4, 8, 16, 32),
          "lz_dvec": (3, 6, 12), "h16": (1,)}


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_cases(dev) -> dict:
    """{name: (scalars, table name)} and the tables, from a SHA-256 1 KiB
    setup and prep."""
    from spartan2_tpu_torch.field.limbs import to_device
    from spartan2_tpu_torch.frontend.gadgets.sha256 import Sha256Circuit
    from spartan2_tpu_torch.pcs.hyrax import FULL_BITS, SMALL_BITS
    from spartan2_tpu_torch.provider.engines import get_engine
    from spartan2_tpu_torch.snark.spartan import SpartanSNARK

    engine = get_engine("P256HyraxEngine")
    circuit = Sha256Circuit(bytes(i & 0xFF for i in range(1024)))
    pk, _ = SpartanSNARK.setup(engine, circuit, width=2048, device=dev)
    prep = SpartanSNARK.prep_prove(pk, circuit, is_small=True)
    S, F, C = pk.S, engine.scalar, pk.ck.num_cols
    wit = prep.ps.W[S.num_shared : S.num_shared + S.num_precommitted]
    scp = to_device(wit, F, dev).reshape(-1, C, 8)
    gen = torch.Generator().manual_seed(0)

    def rand(n):
        vals = [int.from_bytes(torch.randint(0, 256, (32,), generator=gen,
                                             dtype=torch.uint8).numpy().tobytes(),
                               "little") % F.modulus for _ in range(n)]
        return to_device(vals, F, dev)

    tables = {"small": pk.ck.comb(SMALL_BITS).table, "full": pk.ck.comb(FULL_BITS).table,
              "h": pk.ck.comb_h().table}
    cases = {"witness": (scp, "small"), "shard": (scp[: scp.shape[0] // 2].contiguous(), "small"),
             "lz_dvec": (rand(2 * C).reshape(2, C, 8), "full"),
             "h16": (rand(16).reshape(16, 1, 8), "h")}
    return cases, tables


def rows_with_chain(sc, table, curve, k):
    from spartan2_tpu_torch.ec.comb import COMB, curve_words

    R, C = sc.shape[:2]
    n_win = table.shape[0]
    parts = -(-n_win * C // (128 * k))
    scratch = torch.empty(R * parts if parts > 1 else 0, 3, 8, dtype=torch.int32,
                          device=sc.device)
    out = torch.empty(R, 3, 8, dtype=torch.int32, device=sc.device)
    COMB.call("sp2_comb_rows", R, C, n_win, k, sc.data_ptr(), table.data_ptr(),
              scratch.data_ptr(), out.data_ptr(), curve_words(curve))
    return out


def run_old(old: str, run: int) -> dict:
    env = dict(os.environ, PYTHONPATH=old)
    out = subprocess.run([sys.executable, __file__, "--worker", old, "--run", str(run)],
                         env=env, capture_output=True, text=True, timeout=900)
    sys.stdout.write(out.stdout)
    if out.returncode:
        sys.stdout.write(out.stderr[-4000:])
        raise RuntimeError(f"old checkout's run failed ({out.returncode})")
    return torch.load(WORK / "old_out.pt")


def worker(old: str, run: int) -> None:
    sys.path.insert(0, old)
    from spartan2_tpu_torch.ec.comb import comb_rows
    from spartan2_tpu_torch.provider.engines import get_engine

    curve = get_engine("P256HyraxEngine").curve
    data = torch.load(WORK / "cases.pt")
    outs = {}
    for name, (sc, tab) in data["cases"].items():
        sc, table = sc.cuda(), data["tables"][tab].cuda()
        outs[name] = comb_rows(sc, table, curve).cpu()
        ms = cuda_ms(lambda: comb_rows(sc, table, curve))
        print(json.dumps({"run": run, "code": "old", "case": name, "rows": sc.shape[0],
                          "ms": ms}), flush=True)
    torch.save(outs, WORK / "old_out.pt")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", default=None)
    ap.add_argument("--worker", default=None)
    ap.add_argument("--run", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("comb_chain_sweep: no CUDA card", file=sys.stderr)
        return 1
    if args.worker:
        worker(args.worker, args.run)
        return 0
    from chip_smoke import _path_kernels
    from spartan2_tpu_torch.utils.cuda import build_all
    from spartan2_tpu_torch.ec.comb import (comb_chain, comb_rows, comb_rows_plain,
                                            to_affine)
    from spartan2_tpu_torch.provider.engines import get_engine

    print(card_line(), flush=True)
    print(json.dumps({"build_s": build_all(_path_kernels())}), flush=True)
    dev = torch.device("cuda")
    curve = get_engine("P256HyraxEngine").curve
    cases, tables = make_cases(dev)
    WORK.mkdir(parents=True, exist_ok=True)
    torch.save({"cases": {n: (sc.cpu(), t) for n, (sc, t) in cases.items()},
                "tables": {n: t.cpu() for n, t in tables.items()}}, WORK / "cases.pt")
    affine = {}
    for name, (sc, tab) in cases.items():
        table = tables[tab]
        got = comb_rows(sc, table, curve)
        if not torch.equal(got, comb_rows_plain(sc, table, curve)):
            raise RuntimeError(f"{name}: comb_rows differs from its plain version")
        affine[name] = to_affine(got, curve)
        for k in CHAINS[name]:
            if to_affine(rows_with_chain(sc, table, curve, k), curve) != affine[name]:
                raise RuntimeError(f"{name}: chain {k} gives other points")
        print(json.dumps({"case": name, "rows": sc.shape[0], "n_win": table.shape[0],
                          "default_chain": comb_chain(sc.shape[1], table.shape[0]),
                          "exact": True}), flush=True)
    for run in range(4):
        if run % 2:
            if args.old is None:
                continue
            outs = run_old(args.old, run)
            for name in cases:
                if to_affine(outs[name], curve) != affine[name]:
                    raise RuntimeError(f"{name}: the old checkout gives other points")
            continue
        for name, (sc, tab) in cases.items():
            table = tables[tab]
            for k in CHAINS[name]:
                ms = cuda_ms(lambda: rows_with_chain(sc, table, curve, k))
                print(json.dumps({"run": run, "code": "new", "case": name,
                                  "rows": sc.shape[0], "chain": k, "ms": ms}), flush=True)
    log = ROOT / "build" / "kernels"
    for f in sorted(log.glob("comb*.log")):
        print(f"{f.name}: {f.read_text().strip()}", flush=True)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
