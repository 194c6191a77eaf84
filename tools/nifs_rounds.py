"""NeutronNova's NIFS kernels (kernels 3 and 4) at an NN prove's shapes.

    python3 tools/nifs_rounds.py [--pkg DIR] [--grid PATH] [--reps 20]

Times every NIFS launch of a NeutronNova prove over 16 SHA-256 steps
(csrc/nifs.cu through sumcheck/nifs.py): kernel 3's round 0 without the
small gate (16 instances, 8 pairs) and its rounds t = 1, 2, 3 (16 -> 8,
8 -> 4, 4 -> 2 instances, each with the fold of the previous challenge),
the final fold 2 -> 1, kernel 4's small round 0 on the gated grid, and
the two weighted folds (the 16 witness prefixes, and W_fold + c_eval
core_W).  The grid is the prep cache's real one (Az, Bz, Cz of the 16
steps, 3 x 16 x 2^15): built by NeutronNovaZkSNARK's setup, prep and one
prove on first use and kept at PATH (default build/nifs_grid.pt) for the
next run; E, the weights and the challenge are random.  Each launch is
held against its plain version on the card first.  Milliseconds a call by
CUDA events over back-to-back calls (a round's wrapper pulls its two sums
to the host), each kernel's own device microseconds by torch.profiler
(kernel name -> microseconds a launch and launches recorded) and their
sum a call, and the host's microseconds to enqueue a call; then the
ptxas lines of nifs.cu.  The copy of the grid an older prove made before
its in-place rounds is timed as ``grid_clone``; the parent commit's
in-place API is adapted by ``_parent_api``.  DIR (default: this checkout) holds the
spartan2_tpu_torch package to time, e.g. the parent commit's unpacked
under scratch/.  Needs one CUDA card; prints the card's name and power
limit, then one JSON object a line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import random
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tools._timing import (call_us, card_line, events_ms, host_us,  # noqa: E402
                           kernel_us, ptxas_lines, rand_canonical)

STEPS = 16


def real_grid(path: Path) -> dict:
    """The prep cache of a NeutronNova prove over 16 SHA-256 steps, width
    2048 (chip_smoke's NN path): {"ABC", "eff", "num_vars"}."""
    if path.exists():
        return torch.load(path, weights_only=False)
    from spartan2_tpu_torch.frontend.gadgets.sha256 import Sha256Circuit
    from spartan2_tpu_torch.provider.engines import get_engine
    from spartan2_tpu_torch.snark.neutronnova import NeutronNovaZkSNARK as NN

    rnd = random.Random(21)

    def rng(q):
        return rnd.randrange(q)

    engine = get_engine("P256HyraxEngine")
    steps = [Sha256Circuit(bytes([i] * 55)) for i in range(STEPS)]
    core = Sha256Circuit(bytes(55))
    pk, _ = NN.setup(engine, steps[0], core, STEPS, width=2048, device="cuda")
    prep = NN.prep_prove(pk, steps, core, is_small=True, rng=rng)
    _, prep = NN.prove(pk, steps, core, prep, is_small=True, rng=rng)
    S = pk.S_step
    rec = {"ABC": prep.cache["ABC"].cpu(), "eff": S.num_shared + S.num_precommitted,
           "num_vars": S.num_vars}
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(rec, path)
    return rec


def _timed(name: str, fn, reps: int) -> dict:
    dev = kernel_us(fn, reps)
    return {"item": name, "ms": events_ms(fn, reps),
            "device_us_a_call": call_us(dev, reps),
            "kernels": {key[:48]: k for key, k in dev.items()}, "host_us": host_us(fn, reps)}


def _parent_api(nifs):
    """The parent commit's NIFS module (no ``out``: the rounds and the final
    fold fold their rows in place, the weighted fold takes stacked rows)
    under this checkout's signatures, to time both in one call.  A call
    folds a copy of its rows made on its first call, as the parent's prove
    cloned the grid once (timed as ``grid_clone``); that first call, the one
    held against the plain version, also copies the folded rows out."""
    api, copies = SimpleNamespace(**vars(nifs)), {}

    def folded(src, out, fn, *args):
        g = torch.stack(src).clone()
        res = fn(*g, *args)
        if out is not None:
            for o, x in zip(out, g):
                o.copy_(x[: o.shape[0]])
        return res

    def in_place(src, out, fn, *args):
        key = src[0].data_ptr(), src[0].shape[0], args[-2]  # bind, or r
        if key not in copies:
            copies[key] = torch.stack(src).clone()
            return folded(src, out, fn, *args)
        return fn(*copies[key], *args)

    api.nifs_round_plain = lambda A, B, C, E, w, r, bind, spec, out=None: folded(
        (A, B, C), out, nifs.nifs_round_plain, E, w, r, bind, spec)
    api.nifs_round = lambda A, B, C, E, w, r, bind, spec, out=None: in_place(
        (A, B, C), out, nifs.nifs_round, E, w, r, bind, spec)
    api._fold_plain = lambda src, r, spec, outs: folded(
        src, outs, lambda *g: nifs._fold_plain(g[:3], r, spec))
    api.nifs_fold = lambda A, B, C, r, spec, out: in_place((A, B, C), out, nifs.nifs_fold, r,
                                                          spec)
    api.weighted_fold = lambda rows, w, spec: nifs.weighted_fold(torch.stack(rows), w, spec)
    return api


def time_nifs(spec, grid: dict, reps: int = 20, seed: int = 9) -> list[dict]:
    """Every NIFS launch of a prove, on the imported package -> records."""
    from spartan2_tpu_torch.field.limbs import limbs_to_ints
    from spartan2_tpu_torch.sumcheck import nifs

    gen = torch.Generator().manual_seed(seed)
    rnd = random.Random(seed)
    ABC = grid["ABC"].cuda()
    S_small, small_ok = nifs.to_small(*ABC, spec)
    I, n = ABC.shape[1], ABC.shape[2]
    E = rand_canonical(n, spec, gen)
    r = rnd.randrange(spec.modulus)
    fold_out = "out" in inspect.signature(nifs.nifs_round).parameters
    if not fold_out:
        nifs = _parent_api(nifs)
    recs = [{"grid": list(ABC.shape), "small_gate": small_ok, "fold_out": fold_out}]

    def same(name, got, want):
        if isinstance(want, torch.Tensor) and not isinstance(got, torch.Tensor):
            want = limbs_to_ints(want, spec, mont=True)
        ok = torch.equal(got, want) if isinstance(got, torch.Tensor) else got == want
        if not ok:
            raise RuntimeError(f"{name}: kernel differs from its plain version")

    recs.append(_timed("grid_clone (3 x 16 x 2^15)", lambda: ABC.clone(), reps))

    # kernel 3's rounds: t = 0 (no fold) on the grid, t = 1, 2, 3 folding
    # I_in = 16, 16, 8, 4 instances into a buffer
    for t, I_in in ((0, I), (1, I), (2, I // 2), (3, I // 4)):
        bind = t > 0
        pairs = (I_in // 2 if bind else I_in) // 2
        w = rand_canonical(pairs, spec, gen)
        src = tuple(ABC[j, :I_in] for j in range(3))  # contiguous prefixes
        out = torch.empty(3, I_in // 2, n, 8, dtype=torch.int32, device="cuda")
        want_g = torch.empty_like(out)
        want = nifs.nifs_round_plain(*src, E, w, r, bind, spec, want_g if bind else None)
        got = nifs.nifs_round(*src, E, w, r, bind, spec, out=out)
        if bind:
            same(f"round t={t} folded grid", out, want_g)
        same(f"round t={t}", got, want)

        def call(src=src, w=w, out=out, bind=bind):
            nifs.nifs_round(*src, E, w, r, bind, spec, out=out)

        recs.append({**_timed(f"round t={t} ({I_in} -> {I_in // 2 if bind else I_in}, "
                              f"{pairs} pairs)", call, reps), "t": t})

    # the final fold 2 -> 1
    src = tuple(ABC[j, :2] for j in range(3))
    out = torch.empty(3, 1, n, 8, dtype=torch.int32, device="cuda")
    want_g = torch.empty_like(out)
    nifs._fold_plain(src, r, spec, tuple(want_g))
    nifs.nifs_fold(*src, r, spec, out)
    same("final fold", out, want_g)
    recs.append(_timed("final fold (2 -> 1)", lambda: nifs.nifs_fold(*src, r, spec, out),
                       reps))

    # kernel 4's small round 0 on the gated grid
    if small_ok:
        from spartan2_tpu_torch.field.small_value import small_round_plain

        w = rand_canonical(I // 2, spec, gen)
        got = nifs.small_round(S_small, E, w, spec)
        same("small round", got, limbs_to_ints(small_round_plain(S_small, E, w, spec), spec))
        recs.append(_timed(f"small round 0 ({I}, {I // 2} pairs)",
                           lambda: nifs.small_round(S_small, E, w, spec), reps))

    # the weighted folds: 16 witness prefixes, and W_fold + c_eval core_W
    nv, eff = grid["num_vars"], grid["eff"]
    for count, width in ((I, eff), (2, nv)):
        rows = [rand_canonical(nv, spec, gen)[:width] for _ in range(count)]
        w = rand_canonical(count, spec, gen)
        want = nifs.weighted_fold_plain(torch.stack(rows), w, spec)

        def call(rows=rows, w=w):
            return nifs.weighted_fold(rows, w, spec)

        same(f"weighted fold {count} x {width}", call(), want)
        recs.append(_timed(f"weighted fold {count} x {width}", call, reps))
    return recs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", default=str(ROOT), help="directory holding the "
                    "spartan2_tpu_torch package whose kernels are timed")
    ap.add_argument("--grid", default=str(ROOT / "build" / "nifs_grid.pt"),
                    help="the prep cache's grid, built here on first use")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("nifs_rounds: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.pkg).resolve()))
    import spartan2_tpu_torch
    from spartan2_tpu_torch.provider.engines import get_engine
    from spartan2_tpu_torch.sumcheck.nifs import NIFS
    from spartan2_tpu_torch.utils.cuda import build_all

    spec = get_engine("P256HyraxEngine").scalar
    print(card_line(), flush=True)
    print(json.dumps({"package": str(Path(spartan2_tpu_torch.__file__).parent)}), flush=True)
    t0 = time.perf_counter()
    build_all([NIFS])
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"ptxas": NIFS.name, "lines": ptxas_lines(NIFS)}), flush=True)
    t0 = time.perf_counter()
    grid = real_grid(Path(args.grid))
    print(json.dumps({"grid_s": time.perf_counter() - t0}), flush=True)
    with torch.inference_mode():
        for rec in time_nifs(spec, grid, args.reps):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
