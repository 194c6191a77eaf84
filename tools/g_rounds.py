"""Kernel G round by round and kernel 4, at the main path's shapes.

    python3 tools/g_rounds.py [--pkg DIR] [--m 20] [--eff 528177] [--reps 20]

Times the outer sum-check's kernel G (csrc/cubiceq.cu, ``cubiceq_evals``)
at each of the m rounds of a SpartanSNARK prove over 2^m rows (SHA-256 1
KiB: m = 20, round 0 peeled below eff = 528177 constraints): the tables
of SumcheckProverCubicEq's plan (EL over the next fh - j - 1 taus and ER
over the last m - fh while j < fh - 1, fh = m // 2, then one table of
m - j - 1), zero_check in round 0, random canonical inputs; and round 0
as rank 3 of a W = 4 mesh holds it (the shard stride, lw = 2).  Then
kernel 4 (csrc/hyrax_bind.cu, ``hyrax_bind``) at 256 x 2048, the PCS's
rows.  Each is held against its plain version on the card first.
Milliseconds a launch by CUDA events over back-to-back launches, the
kernels' own device microseconds by torch.profiler, and the host's
microseconds to enqueue a call (no synchronize); then the ptxas lines of
both libraries.  DIR (default: this checkout) holds the spartan2_tpu_torch
package to time, e.g. the parent commit's unpacked under scratch/.
Needs one CUDA card; prints the card's name and power limit, then one
JSON object a line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tools._timing import (card_line, device_us, events_ms, host_us,  # noqa: E402
                           ptxas_lines, rand_canonical)


def g_rounds(m: int, eff: int) -> list[dict]:
    """Kernel G's arguments a round of the outer sum-check over 2^m rows
    (sumcheck/prove.py SumcheckProverCubicEq: plan, upper_live, rounds)."""
    n, fh = 1 << m, m // 2
    out = []
    for j in range(m):
        half = n >> (j + 1)
        live = min(n // 2, max(0, eff - n // 2)) if j == 0 else half
        two = j < fh - 1
        out.append({"round": j, "half": half, "hi_len": live, "zero_check": j == 0,
                    "el_vars": fh - j - 1 if two else None,
                    "er_vars": m - fh if two else m - j - 1,
                    "rlog": m - fh if two else 0})
    return out


def _timed(fn, reps: int, key: str) -> dict:
    return {"ms": events_ms(fn, reps), "device_us": device_us(fn, reps, key),
            "host_us": host_us(fn, reps)}


def time_g_rounds(spec, m: int = 20, eff: int = 528177, reps: int = 20,
                  seed: int = 7, W: int = 0) -> list[dict]:
    """Kernel G of the imported package at every round of the outer
    sum-check, each held against its plain version -> records; given W,
    round 0 only, as rank W - 1 of a W-rank mesh holds it."""
    from spartan2_tpu_torch.field.limbs import limbs_to_ints
    from spartan2_tpu_torch.sumcheck import device
    from spartan2_tpu_torch.sumcheck.device import cubiceq_evals, cubiceq_evals_plain

    gen = torch.Generator().manual_seed(seed)
    p = spec.modulus
    A, B, C = (rand_canonical(1 << m, spec, gen) for _ in range(3))
    takes_ticket = "ticket" in inspect.signature(cubiceq_evals).parameters
    ticket = device.new_ticket("cuda") if takes_ticket else None
    out = []
    for r in g_rounds(m, eff)[: 1 if W else m]:
        EL = None if r["el_vars"] is None else rand_canonical(1 << r["el_vars"], spec, gen)
        ER = rand_canonical(1 << r["er_vars"], spec, gen)
        args = (A, B, C, r["half"], r["hi_len"], EL, ER, r["rlog"], r["zero_check"], False,
                spec)
        if W:  # rank W - 1: local pairs half / W, its live upper rows, lw = log2(W)
            s, lw = W - 1, W.bit_length() - 1
            r = {**r, "shard": s, "half": r["half"] // W,
                 "hi_len": min(r["half"] // W, max(0, -(-(r["hi_len"] - s) // W)))}
            args = (*args[:3], r["half"], r["hi_len"], *args[5:], s, lw)
        extra = {"ticket": ticket} if takes_ticket else {}
        got = cubiceq_evals(*args, **extra)
        want = cubiceq_evals_plain(*args)
        sums = [sum(col) % p for col in zip(*[limbs_to_ints(b, spec, mont=True)
                                              for b in got.cpu()])]
        if sums != limbs_to_ints(want[0], spec, mont=True):
            raise RuntimeError(f"kernel G, round {r['round']}: differs from its plain version")

        def run():
            cubiceq_evals(*args, **extra)

        out.append({**r, "rows_out": got.shape[0], **_timed(run, reps, "cubiceq")})
    return out


def g_summary(rounds: list[dict]) -> dict:
    """G's device us in rounds 0, 1, 2, the tail and all rounds; a sum
    over a round the profiler did not record is null, not a partial sum."""
    dev = [r["device_us"] for r in rounds]

    def total(xs):
        return None if None in xs else sum(xs)

    return {"round0_us": dev[0], "round1_us": dev[1], "round2_us": dev[2],
            "tail_us": total(dev[3:]), "all_us": total(dev)}


def time_hyrax_bind(spec, R: int = 256, C: int = 2048, reps: int = 20,
                    seed: int = 8) -> dict:
    """Kernel 4 of the imported package at R x C against its plain version."""
    from spartan2_tpu_torch.pcs.hyrax import hyrax_bind, hyrax_bind_plain

    gen = torch.Generator().manual_seed(seed)
    L = rand_canonical(R, spec, gen)
    poly = rand_canonical(R * C, spec, gen).reshape(R, C, 8)
    if not torch.equal(hyrax_bind(L, poly, spec), hyrax_bind_plain(L, poly, spec)):
        raise RuntimeError("kernel 4 differs from its plain version")

    def run():
        hyrax_bind(L, poly, spec)

    return {"hyrax_bind": f"{R} x {C}", **_timed(run, reps, "hyrax_bind")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", default=str(ROOT), help="directory holding the "
                    "spartan2_tpu_torch package whose kernels are timed")
    ap.add_argument("--m", type=int, default=20)
    ap.add_argument("--eff", type=int, default=528177)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("g_rounds: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.pkg).resolve()))
    import spartan2_tpu_torch
    from spartan2_tpu_torch.pcs.hyrax import HYRAX_BIND
    from spartan2_tpu_torch.provider.engines import get_engine
    from spartan2_tpu_torch.sumcheck.device import CUBICEQ
    from spartan2_tpu_torch.utils.cuda import build_all

    spec = get_engine("P256HyraxEngine").scalar
    print(card_line(), flush=True)
    print(json.dumps({"package": str(Path(spartan2_tpu_torch.__file__).parent)}), flush=True)
    t0 = time.perf_counter()
    build_all([CUBICEQ, HYRAX_BIND])
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    for k in (CUBICEQ, HYRAX_BIND):
        print(json.dumps({"ptxas": k.name, "lines": ptxas_lines(k)}), flush=True)
    rounds = time_g_rounds(spec, args.m, args.eff, args.reps)
    for rec in rounds:
        print(json.dumps(rec), flush=True)
    print(json.dumps({"g_device_us": g_summary(rounds)}), flush=True)
    strided = time_g_rounds(spec, args.m, args.eff, args.reps, W=4)[0]
    print(json.dumps({"strided": strided}), flush=True)
    print(json.dumps(time_hyrax_bind(spec, reps=args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
