"""Latency of a sum-check round's finish (kernel F) on the card, and of the
chains it is made of.

    python3 tools/round_latency.py [--pkg DIR] [--no-chains] [--no-f]

Builds a probe library with nvcc for sm_90a into build/latency_probe/ and
times, as the difference of a 2n and an n chain over n (so that the
launch drops out), in one block: Keccak-f[1600] on one thread (the
port's permutation before the warp-wide one, copied here for reference),
Keccak-f[1600] spread over one warp (csrc/keccak.cuh), and the
carry-chain Montgomery product fe_mul_cc (csrc/field.cuh).  Each chain's
result is held against the host's (transcript/keccak.py, Python
integers).  Then times kernel F of the package found in DIR (default:
this checkout; e.g. the parent commit's package unpacked under scratch/)
in each mode (Gruen with zero_check, plain and with fallback, cubic
evals, quad, inner round 0), from one row of sums and from 1024 rows (the
most rows of sums it was given before kernel G finished its own): milliseconds a launch by CUDA events
over back-to-back launches, and the kernel's own device microseconds by
torch.profiler.  Needs one CUDA card and the CUDA toolkit; prints the
card's name and power limit, then one JSON object a line.

``latency_probe`` and ``f_latency_floor`` give chip_smoke.py kernel F's
latency floor: F's product depth times fe_mul_cc's latency, plus its two
permutations in sequence.
"""

from __future__ import annotations

import argparse
import itertools
import json
import random
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tools._timing import card_line, device_us, ptxas_lines  # noqa: E402
WORK = ROOT / "build" / "latency_probe"

PROBE = r"""
#include "field.cuh"
#include "keccak.cuh"
using namespace sp2;

// Keccak-f[1600] on one thread, the 25 lanes in registers: the port's
// permutation before keccak_f1600_warp, kept here only to be timed beside it.
__device__ __forceinline__ void keccak_f1600_thread(uint64_t st[25]) {
  constexpr int ROTC[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                            27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
  constexpr int PILN[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                            15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};
  for (int rnd = 0; rnd < 24; ++rnd) {
    uint64_t bc[5];
#pragma unroll
    for (int i = 0; i < 5; ++i)
      bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const uint64_t t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
#pragma unroll
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    uint64_t t = st[1];
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const uint64_t b = st[PILN[i]];
      st[PILN[i]] = rotl64(t, ROTC[i]);
      t = b;
    }
#pragma unroll
    for (int j = 0; j < 25; j += 5) {
#pragma unroll
      for (int i = 0; i < 5; ++i) bc[i] = st[j + i];
#pragma unroll
      for (int i = 0; i < 5; ++i) st[j + i] ^= (~bc[(i + 1) % 5]) & bc[(i + 2) % 5];
    }
    st[0] ^= KECCAK_RC[rnd];
  }
}

__global__ void keccak_thread_kernel(int n, uint64_t* io) {
  uint64_t st[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) st[i] = io[i];
  for (int k = 0; k < n; ++k) keccak_f1600_thread(st);
#pragma unroll
  for (int i = 0; i < 25; ++i) io[i] = st[i];
}

__global__ void keccak_warp_kernel(int n, uint64_t* io) {
  const int l = threadIdx.x;
  uint64_t a = l < 25 ? io[l] : 0;
  for (int k = 0; k < n; ++k) a = keccak_f1600_warp(a);
  if (l < 25) io[l] = a;
}

__global__ void mul_chain_kernel(int n, uint32_t* io, Field F) {
  Fe x = fe_load(io, 0);
  const Fe y = fe_load(io, 1);
  for (int k = 0; k < n; ++k) x = fe_mul_cc(x, y, F);
  fe_store(io, 0, x);
}

// which: 0 Keccak-f on one thread, 1 on one warp, 2 fe_mul_cc
extern "C" int sp2_latency_chain(int which, int n, void* io, const uint32_t* field_words,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (which == 0) keccak_thread_kernel<<<1, 1, 0, s>>>(n, (uint64_t*)io);
  else if (which == 1) keccak_warp_kernel<<<1, 32, 0, s>>>(n, (uint64_t*)io);
  else if (which == 2)
    mul_chain_kernel<<<1, 1, 0, s>>>(n, (uint32_t*)io, field_from_words(field_words));
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
"""

KECCAK_THREAD, KECCAK_WARP, MUL_CC = 0, 1, 2
CHAIN_NAMES = {KECCAK_THREAD: "keccak_f1600 one thread", KECCAK_WARP: "keccak_f1600 one warp",
               MUL_CC: "fe_mul_cc"}
CHAIN_N = {KECCAK_THREAD: 64, KECCAK_WARP: 64, MUL_CC: 1024}


def latency_probe():
    """A CudaKernel of PROBE (source under build/latency_probe/), for
    ``build_all`` beside the port's kernels."""
    from spartan2_tpu_torch.utils.cuda import I, P, CudaKernel

    WORK.mkdir(parents=True, exist_ok=True)
    src = WORK / "round_latency.cu"
    src.write_text(PROBE)
    probe = CudaKernel("round_latency", {"sp2_latency_chain": [I, I, P, P]})
    probe.source = src
    return probe


def _chain_input(which: int, spec, device) -> torch.Tensor:
    rnd = random.Random(which)
    if which == MUL_CC:
        from spartan2_tpu_torch.field.limbs import to_device

        return to_device([rnd.randrange(spec.modulus) for _ in range(2)], spec, device,
                         mont=True)
    lanes = [rnd.getrandbits(64) for _ in range(25)]
    return torch.tensor([v - (1 << 64) if v >= 1 << 63 else v for v in lanes],
                        dtype=torch.int64, device=device)


def run_chain(probe, which: int, n: int, io: torch.Tensor, spec) -> torch.Tensor:
    """n steps of chain ``which`` on a copy of io -> the copy."""
    from spartan2_tpu_torch.utils.cuda import field_words

    out = io.clone()
    probe.call("sp2_latency_chain", which, n, out.data_ptr(), field_words(spec))
    return out


def check_chain(probe, which: int, spec, n: int = 3) -> None:
    """Chain ``which`` against the host: Keccak-f by transcript/keccak.py,
    the product by Python integers."""
    from spartan2_tpu_torch.field.limbs import limbs_to_ints
    from spartan2_tpu_torch.transcript.keccak import keccak_f1600

    io = _chain_input(which, spec, "cuda")
    got = run_chain(probe, which, n, io, spec).cpu()
    if which == MUL_CC:
        x, y = limbs_to_ints(io.cpu(), spec, mont=True)
        want = x * pow(y, n, spec.modulus) % spec.modulus
        ok = limbs_to_ints(got, spec, mont=True)[0] == want
    else:
        st = [v & ((1 << 64) - 1) for v in io.cpu().tolist()]
        for _ in range(n):
            st = keccak_f1600(st)
        ok = [v & ((1 << 64) - 1) for v in got.tolist()] == st
    if not ok:
        raise RuntimeError(f"{CHAIN_NAMES[which]} chain differs from the host's")


def chain_us(probe, which: int, spec, n: int | None = None, reps: int = 5) -> float:
    """Microseconds a step of chain ``which``: the difference of a 2n and
    an n chain over n, each timed by CUDA events."""
    n = n or CHAIN_N[which]
    io = _chain_input(which, spec, "cuda")

    def ms(k):
        run_chain(probe, which, k, io, spec)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run_chain(probe, which, k, io, spec)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    return (ms(2 * n) - ms(n)) * 1e3 / n


# Kernel F's dependent Montgomery products per mode (csrc/round_finish.cu):
# the round algebra with its canonical coefficients, from_uniform, then p(r)
# (and P eq(tau, r)).  GRUEN: Tinf / T0, c3 / c0, e1 / tau, t(-1)'s
# product, the canonical c2; with fallback t(-1) P replaces e1 / tau's
# chain, one fewer.
F_DEPTH = {"gruen": 5 + 1 + 2, "gruen_fallback": 4 + 1 + 2, "cubic_evals": 3 + 1 + 2,
           "quad": 2 + 1 + 2, "inner0": 2 + 1 + 2}
F_PERMUTATIONS = 2  # two 136-byte blocks in sequence; the two hashes side by side


def f_latency_floor(probe, spec, mode: str = "gruen") -> dict:
    """Kernel F's latency floor (ms) in ``mode``: its product depth times
    fe_mul_cc's latency plus two warp-wide permutations, each measured."""
    for which in (KECCAK_WARP, MUL_CC):
        check_chain(probe, which, spec)
    mul_us = chain_us(probe, MUL_CC, spec)
    perm_us = chain_us(probe, KECCAK_WARP, spec)
    floor = (F_DEPTH[mode] * mul_us + F_PERMUTATIONS * perm_us) / 1e3
    return {"latency_floor_ms": floor, "depth": F_DEPTH[mode], "mul_cc_us": mul_us,
            "permutation_us": perm_us}


def f_cases(spec, dev):
    """Kernel F's inputs per mode: (name, mode, sums rows, ctx, consts,
    zero_check, fallback)."""
    from spartan2_tpu_torch.field.limbs import to_device
    from spartan2_tpu_torch.sumcheck.prove import CUBIC_EVALS, GRUEN, INNER0, QUAD_EVALS

    p = spec.modulus
    rnd = random.Random(3)
    tau = rnd.randrange(p)
    consts = to_device([(1 - tau) % p, (2 * tau - 1) % p, (2 - 3 * tau) % p,
                        pow(tau, -1, p)], spec, dev, mont=True)
    consts0 = to_device([1, p - 1, 2, 0], spec, dev, mont=True)  # tau = 0
    state = torch.tensor(list(range(64)), dtype=torch.uint8, device=dev).view(torch.int32)
    ctx = torch.cat([to_device([rnd.randrange(p), rnd.randrange(p)], spec, dev, mont=True),
                     state.reshape(2, 8)])
    cases = []
    for rows in (1, 1024):
        for name, mode, c, zc, fb in (("gruen_zero_check", GRUEN, consts, True, False),
                                      ("gruen", GRUEN, consts, False, False),
                                      ("gruen_fallback", GRUEN, consts0, False, True),
                                      ("cubic_evals", CUBIC_EVALS, None, False, False),
                                      ("quad", QUAD_EVALS, None, False, False),
                                      ("inner0", INNER0, None, False, False)):
            ns = 2 if mode == QUAD_EVALS else 3
            sums = to_device([rnd.randrange(p) for _ in range(rows * ns)], spec, dev,
                             mont=True).reshape(rows, ns, 8)
            cases.append((name, mode, rows, sums, ctx, c, zc, fb))
    return cases


def time_f(spec, reps: int = 200) -> list:
    """Kernel F of the imported package in each mode -> records."""
    from spartan2_tpu_torch.sumcheck.prove import (_NCOEFFS, ROUND_FINISH, round_finish,
                                                   round_finish_plain)

    dev = torch.device("cuda")
    out = []
    for name, mode, rows, sums, ctx, consts, zc, fb in f_cases(spec, dev):
        coeffs = torch.empty(_NCOEFFS[mode], 8, dtype=torch.int32, device=dev)
        r = torch.empty(2, 8, dtype=torch.int32, device=dev)
        c1 = ctx.clone()
        round_finish(mode, sums, c1, coeffs, r, 7, spec, consts, zc, fb)
        cpu = [t.cpu() for t in (sums, ctx, coeffs, r)]
        round_finish_plain(mode, cpu[0], cpu[1], cpu[2], cpu[3], 7, spec,
                           None if consts is None else consts.cpu(), zc, fb)
        if not (torch.equal(c1.cpu(), cpu[1]) and torch.equal(coeffs.cpu(), cpu[2])
                and torch.equal(r.cpu(), cpu[3])):
            raise RuntimeError(f"kernel F ({name}) differs from its plain version")
        ctxs = [ctx.clone() for _ in range(reps + 1)]

        def run(i):
            round_finish(mode, sums, ctxs[i], coeffs, r, 7, spec, consts, zc, fb)

        run(reps)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            run(i)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        calls = itertools.cycle(range(reps + 1))
        dev_us = device_us(lambda: run(next(calls)), reps, "round_finish")
        out.append({"f_mode": name, "rows": rows, "ms": ms, "device_us": dev_us})
    out.append({"round_finish_ptxas": ptxas_lines(ROUND_FINISH)})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", default=str(ROOT), help="directory holding the "
                    "spartan2_tpu_torch package whose kernel F is timed")
    ap.add_argument("--no-chains", action="store_true")
    ap.add_argument("--no-f", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("round_latency: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.pkg).resolve()))
    import spartan2_tpu_torch
    from spartan2_tpu_torch.provider.engines import get_engine
    from spartan2_tpu_torch.utils.cuda import build_all

    spec = get_engine("P256HyraxEngine").scalar
    print(card_line(), flush=True)
    print(json.dumps({"package": str(Path(spartan2_tpu_torch.__file__).parent)}), flush=True)
    if not args.no_chains:
        probe = latency_probe()
        t0 = time.perf_counter()
        build_all([probe])
        print(json.dumps({"probe_build_s": time.perf_counter() - t0}), flush=True)
        for which in CHAIN_NAMES:
            check_chain(probe, which, spec)
            print(json.dumps({"chain": CHAIN_NAMES[which], "n": CHAIN_N[which],
                              "us_per_step": chain_us(probe, which, spec)}), flush=True)
        for mode in F_DEPTH:
            print(json.dumps({"f_floor_mode": mode, **f_latency_floor(probe, spec, mode)}),
                  flush=True)
    if not args.no_f:
        for rec in time_f(spec):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
