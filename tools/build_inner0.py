"""The comb table build and kernel B's inner round-0 sums at the main
path's shapes.

    python3 tools/build_inner0.py [--pkg DIR] [--reps 10]

Times ``comb_build`` (csrc/comb.cu through ec/comb.py) at the three tables
a Hyrax key of width 2048 builds on first use (pcs/hyrax.py
HyraxCommitmentKey.comb / comb_h): 43 windows x 2048 generators (full
scalars), 11 x 2048 (the witness's small scalars) and 43 x 1 (the blind
generator h), on P-256 (the main path) and on Pallas; then kernel B's sums
(csrc/sumcheck.cu through sumcheck/device.py ``inner0_sums``) at SHA-256 1
KiB's inner round 0: num_vars 2^19, num_extra 257, num_cols 524545, one
instance.  The generators are the curve's hash-to-curve points of a fixed
label, the sums' inputs random canonical elements.  Each table is held
against its plain version first (the first 32 columns of the table, and
the table of h, on the host: the columns are independent), the sums
against theirs on the card.  A table's device microseconds a call are the
sum over its kernels of the profiler's mean a launch; the sums' are the
kernel's alone, with a 128 MB buffer written before each launch so that
abc and z (33.6 MB, which fit in the 50 MB L2) come from device memory,
and with a 128 MB buffer read instead (the write leaves dirty lines in the
L2, which the sums' loads must write back).  Then kernel B's two floors at
its main blocks' grid, by a probe built beside the kernels: the same loads
with no products, and the same unreduced products and reduction with no
loads.  Milliseconds a call by CUDA events as well.  DIR (default: this checkout)
holds the spartan2_tpu_torch package to time, e.g. the parent commit's
unpacked under scratch/.  Needs one CUDA card; prints the card's name and
power limit, then one JSON object a line, then the ptxas lines.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tools._timing import (call_us, card_line, events_ms, kernel_us,  # noqa: E402
                           ptxas_lines, rand_canonical)

WIDTH = 2048
NUM_VARS, NUM_EXTRA = 1 << 19, 257
FLUSH_BYTES = 128 << 20  # more than the H100's 50 MB L2
CHECK_COLS = 32
WORK = ROOT / "build" / "latency_probe"

# Kernel B's main blocks (csrc/sumcheck.cu inner0_evals_kernel: B_NT = 256
# threads, B_U = 4 columns a thread a chunk, two blocks an SM) with only
# their loads, or only their products and reduction.
PROBE = r"""
#include "field.cuh"
using namespace sp2;
constexpr int NT = 256, U = 4;

__global__ void __launch_bounds__(NT, 2) loads_kernel(size_t n, const uint32_t* a,
                                                      const uint32_t* z, uint32_t* out) {
  uint32_t acc = 0;
  for (size_t j0 = blockIdx.x * (size_t)NT * U + threadIdx.x; j0 < n;
       j0 += (size_t)gridDim.x * NT * U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t j = j0 + (size_t)u * NT;
      if (j < n) {
        const Fe x = fe_load(a, j), y = fe_load(z, j);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc += x.v[i] ^ y.v[i];
      }
    }
  }
  if (acc == 0x9E3779B9u) out[0] = acc;  // keeps the loads
}

__global__ void __launch_bounds__(NT, 2) products_kernel(size_t n, uint32_t* out, Field F) {
  Acc e0 = acc_zero();
  for (size_t j0 = blockIdx.x * (size_t)NT * U + threadIdx.x; j0 < n;
       j0 += (size_t)gridDim.x * NT * U) {
    Fe a[U], x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        a[u].v[i] = (uint32_t)((j0 + u) * 2654435761u + i);
        x[u].v[i] = a[u].v[i] ^ 0x5BD1E995u;
      }
      a[u].v[7] &= 0x0FFFFFFFu;
      x[u].v[7] &= 0x0FFFFFFFu;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (j0 + (size_t)u * NT < n) fe_mul_acc(e0, a[u], x[u]);
  }
  const Fe s = acc_reduce(e0, F);
  if (s.v[0] == 0x9E3779B9u) out[0] = s.v[1];  // keeps the products
}

// which: 0 the loads, 1 the products
extern "C" int sp2_inner0_floor(int which, size_t n, int grid, const void* a, const void* z,
                                void* out, const uint32_t* field_words, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (which == 0)
    loads_kernel<<<grid, NT, 0, s>>>(n, (const uint32_t*)a, (const uint32_t*)z,
                                     (uint32_t*)out);
  else if (which == 1)
    products_kernel<<<grid, NT, 0, s>>>(n, (uint32_t*)out, field_from_words(field_words));
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
"""


def floor_probe():
    """A CudaKernel of PROBE (source under build/latency_probe/), for
    ``build_all`` beside the port's kernels."""
    from spartan2_tpu_torch.utils.cuda import SZ, I, P, CudaKernel

    WORK.mkdir(parents=True, exist_ok=True)
    src = WORK / "inner0_floor.cu"
    src.write_text(PROBE)
    probe = CudaKernel("inner0_floor", {"sp2_inner0_floor": [I, SZ, I, P, P, P, P]})
    probe.source = src
    return probe


def time_comb_build(curve_name: str, reps: int) -> list[dict]:
    """comb_build's three tables on one curve -> records."""
    from spartan2_tpu_torch.ec.comb import comb_build, comb_build_plain
    from spartan2_tpu_torch.ec.curve import get_curve
    from spartan2_tpu_torch.field.limbs import to_device

    curve = get_curve(curve_name)
    gens = curve.from_label(b"build_inner0", WIDTH + 1)
    recs = []
    for n_win, pts in ((43, gens[:WIDTH]), (11, gens[:WIDTH]), (43, gens[WIDTH:])):
        gx = to_device([g[0] for g in pts], curve.base, "cuda", mont=True)
        gy = to_device([g[1] for g in pts], curve.base, "cuda", mont=True)
        table = comb_build(gx, gy, n_win, curve)
        k = min(CHECK_COLS, len(pts))
        want = comb_build_plain(gx[:k].cpu(), gy[:k].cpu(), n_win, curve)
        if not torch.equal(table[:, :, :k].cpu(), want):
            raise RuntimeError(f"comb_build {curve_name} {n_win} x {len(pts)}: the kernel "
                               "differs from its plain version")

        def call(gx=gx, gy=gy, n_win=n_win):
            comb_build(gx, gy, n_win, curve)

        dev = kernel_us(call, reps)
        recs.append({"item": f"comb_build {curve_name} {n_win} x {len(pts)}",
                     "checked_cols": k, "ms": events_ms(call, reps),
                     "device_us_a_call": call_us(dev, reps),
                     "kernels": {key[:48]: v for key, v in dev.items()}})
    return recs


def time_inner0(reps: int, probe) -> list[dict]:
    """Kernel B's sums at SHA-256 1 KiB's inner round 0, L2 cold (after a
    write, after a read) and warm; then its floors."""
    from spartan2_tpu_torch.provider.engines import get_engine
    from spartan2_tpu_torch.sumcheck.device import inner0_evals_plain, inner0_sums
    from spartan2_tpu_torch.utils.cuda import field_words

    spec = get_engine("P256HyraxEngine").scalar
    gen = torch.Generator().manual_seed(3)
    cols = NUM_VARS + NUM_EXTRA
    abc, z = rand_canonical(cols, spec, gen), rand_canonical(cols, spec, gen)
    got = inner0_sums(abc, z, NUM_VARS, NUM_EXTRA, spec)
    if not torch.equal(got, inner0_evals_plain(abc, z, NUM_VARS, NUM_EXTRA, spec)):
        raise RuntimeError("inner0_sums: the kernel differs from its plain version")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")

    def cold():
        flush.fill_(1)
        inner0_sums(abc, z, NUM_VARS, NUM_EXTRA, spec)

    def cold_read():
        flush.sum()
        inner0_sums(abc, z, NUM_VARS, NUM_EXTRA, spec)

    def warm():
        inner0_sums(abc, z, NUM_VARS, NUM_EXTRA, spec)

    recs = []
    for name, fn in (("cold L2", cold), ("cold L2, read flush", cold_read), ("warm L2", warm)):
        dev = kernel_us(fn, reps)
        mine = {k: v for k, v in dev.items() if "inner0_evals" in k}
        recs.append({"item": f"inner0_sums num_cols={cols} ({name})",
                     "device_us": call_us(mine, reps), "events_ms": events_ms(fn, reps),
                     "kernels": {key[:48]: v for key, v in dev.items()}})
    # the floors over the main blocks' columns at their grid (264 blocks)
    out = torch.zeros(4, dtype=torch.int32, device="cuda")
    for which, name in ((0, "loads"), (1, "products")):
        def floor(which=which):
            probe.call("sp2_inner0_floor", which, NUM_VARS - NUM_EXTRA, 264,
                       abc[NUM_EXTRA:].data_ptr(), z[NUM_EXTRA:].data_ptr(), out.data_ptr(),
                       field_words(spec))

        for mode, fn in (("cold L2", lambda: (flush.fill_(1), floor())), ("warm L2", floor)):
            dev = kernel_us(fn, reps)
            mine = {k: v for k, v in dev.items() if "_kernel" in k and "vectorized" not in k}
            recs.append({"item": f"inner0 floor: {name} only ({mode})",
                         "device_us": call_us(mine, reps)})
    return recs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", default=str(ROOT), help="directory holding the "
                    "spartan2_tpu_torch package whose kernels are timed")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("build_inner0: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.pkg).resolve()))
    import spartan2_tpu_torch
    from spartan2_tpu_torch.ec.comb import COMB
    from spartan2_tpu_torch.sumcheck.device import SUMCHECK
    from spartan2_tpu_torch.utils.cuda import build_all

    print(card_line(), flush=True)
    print(json.dumps({"package": str(Path(spartan2_tpu_torch.__file__).parent)}), flush=True)
    probe = floor_probe()
    t0 = time.perf_counter()
    build_all([COMB, SUMCHECK, probe])
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    with torch.inference_mode():
        for rec in time_inner0(5 * args.reps, probe):
            print(json.dumps(rec), flush=True)
        for curve_name in ("p256", "pallas"):
            for rec in time_comb_build(curve_name, args.reps):
                print(json.dumps(rec), flush=True)
    for k in (COMB, SUMCHECK):
        print(json.dumps({"ptxas": k.name, "lines": ptxas_lines(k)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
