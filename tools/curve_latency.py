"""Latency of the curve arithmetic in one thread on the card, and the
instructions each operation compiles to.

    python3 tools/curve_latency.py [--src FILE.cu ...]

Builds a probe library from spartan2_tpu_torch/csrc (field.cuh, curve.cuh)
with nvcc for sm_90a into build/latency_probe/, and times, in one thread
of one block, dependent chains of: the Montgomery product (fe_mul, the
64-bit C version, and fe_mul_cc, the PTX carry chains), one chain and
three independent chains side by side; the field addition (fe_add,
fe_add_cc); the doubling (pt_dbl, general a, and pt_dbl_k with each
arithmetic, OpsC and OpsCC, on P-256 (a = -3) and Pallas (a = 0)); the
complete addition (pt_add and pt_add_k); the doubling of a quad of
lanes (pt_dbl_quad_n, the windowed MSM's ladder).  Every chain's result must
equal the old functions' limb for limb.  ``cuobjdump -sass`` counts the
SASS instructions of one product, doubling and addition (a kernel doing
one operation, less a kernel that only loads and stores), and ptxas
reports registers.  ``--src`` adds a source's kernels (registers and SASS
instructions of each __global__ function), e.g. another checkout's
msm.cu.  Needs one CUDA card and the CUDA toolkit; prints the card's name
and power limit, then one JSON object a line.

``dbl_chain_probe`` and ``dbl_chain_floor_ms`` time the windowed MSM's
doubling alone (a quad of lanes, no table, window sums or additions):
chip_smoke.py takes 255 of them in sequence as kernel C's latency floor.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tools._timing import card_line  # noqa: E402
WORK = ROOT / "build" / "latency_probe"

PROBE = r"""
#include "curve.cuh"
using namespace sp2;

// which: 0 fe_mul, 1 fe_mul_cc, 2 three fe_mul chains, 3 three fe_mul_cc
// chains, 4 pt_dbl, 5 pt_dbl_k<OpsC>, 6 pt_dbl_k<OpsCC>, 7 pt_add,
// 8 pt_add_k<OpsC>, 9 pt_add_k<OpsCC>, 10 pt_dbl_quad_n<OpsCC> (four lanes),
// 11 fe_add, 12 fe_add_cc.
// in: P (3 Fe), Q (3 Fe).
template <int W>
__global__ void chain_kernel(int n, const uint32_t* in, uint32_t* out, Curve C) {
  const Field& F = C.F;
  const int ak = curve_a_kind(C);
  Pt P = pt_load(in, 0), Q = pt_load(in, 1);
  if (W == 11 || W == 12) {
    Fe x = P.X;
    for (int i = 0; i < n; ++i) x = W == 11 ? fe_add(x, Q.X, F) : fe_add_cc(x, Q.X, F);
    P.X = x;
  } else if (W <= 3) {
    Fe x = P.X, y = P.Y, z = P.Z;
    for (int i = 0; i < n; ++i) {
      if (W == 0) x = fe_mul(x, Q.X, F);
      if (W == 1) x = fe_mul_cc(x, Q.X, F);
      if (W == 2) { x = fe_mul(x, Q.X, F); y = fe_mul(y, Q.Y, F); z = fe_mul(z, Q.Z, F); }
      if (W == 3) { x = fe_mul_cc(x, Q.X, F); y = fe_mul_cc(y, Q.Y, F); z = fe_mul_cc(z, Q.Z, F); }
    }
    P.X = x; P.Y = y; P.Z = z;
  } else if (W == 10) {
    P = pt_dbl_quad_n<OpsCC>(P, n, C, ak);
  } else {
    for (int i = 0; i < n; ++i) {
      if (W == 4) P = pt_dbl(P, C);
      if (W == 5) P = pt_dbl_k<OpsC>(P, C, ak);
      if (W == 6) P = pt_dbl_k<OpsCC>(P, C, ak);
      if (W == 7) P = pt_add(P, Q, C);
      if (W == 8) P = pt_add_k<OpsC>(P, Q, C, ak);
      if (W == 9) P = pt_add_k<OpsCC>(P, Q, C, ak);
    }
  }
  if (threadIdx.x == 0) pt_store(out, 0, P);
}

// one operation each, for the instruction counts
__global__ void one_copy(const uint32_t* in, uint32_t* out, Curve C) {
  pt_store(out, 0, pt_load(in, 0));
}
__global__ void one_fe_mul(const uint32_t* in, uint32_t* out, Curve C) {
  Pt P = pt_load(in, 0);
  P.X = fe_mul(P.X, P.Y, C.F);
  pt_store(out, 0, P);
}
__global__ void one_fe_mul_cc(const uint32_t* in, uint32_t* out, Curve C) {
  Pt P = pt_load(in, 0);
  P.X = fe_mul_cc(P.X, P.Y, C.F);
  pt_store(out, 0, P);
}
__global__ void one_pt_dbl(const uint32_t* in, uint32_t* out, Curve C) {
  pt_store(out, 0, pt_dbl(pt_load(in, 0), C));
}
__global__ void one_pt_dbl_k_cc(const uint32_t* in, uint32_t* out, Curve C) {
  pt_store(out, 0, pt_dbl_k<OpsCC>(pt_load(in, 0), C, A_MINUS3));
}
__global__ void one_pt_add(const uint32_t* in, uint32_t* out, Curve C) {
  pt_store(out, 0, pt_add(pt_load(in, 0), pt_load(in, 1), C));
}
__global__ void one_pt_add_k_cc(const uint32_t* in, uint32_t* out, Curve C) {
  pt_store(out, 0, pt_add_k<OpsCC>(pt_load(in, 0), pt_load(in, 1), C, A_MINUS3));
}

extern "C" int probe(int which, int n, const void* in, void* out,
                     const uint32_t* curve_words, void* stream) {
  Curve C = curve_from_words(curve_words);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* i = (const uint32_t*)in;
  uint32_t* o = (uint32_t*)out;
  switch (which) {
    case 0: chain_kernel<0><<<1, 1, 0, s>>>(n, i, o, C); break;
    case 1: chain_kernel<1><<<1, 1, 0, s>>>(n, i, o, C); break;
    case 2: chain_kernel<2><<<1, 1, 0, s>>>(n, i, o, C); break;
    case 3: chain_kernel<3><<<1, 1, 0, s>>>(n, i, o, C); break;
    case 4: chain_kernel<4><<<1, 1, 0, s>>>(n, i, o, C); break;
    case 5: chain_kernel<5><<<1, 1, 0, s>>>(n, i, o, C); break;
    case 6: chain_kernel<6><<<1, 1, 0, s>>>(n, i, o, C); break;
    case 7: chain_kernel<7><<<1, 1, 0, s>>>(n, i, o, C); break;
    case 8: chain_kernel<8><<<1, 1, 0, s>>>(n, i, o, C); break;
    case 9: chain_kernel<9><<<1, 1, 0, s>>>(n, i, o, C); break;
    case 10: chain_kernel<10><<<1, 4, 0, s>>>(n, i, o, C); break;
    case 11: chain_kernel<11><<<1, 1, 0, s>>>(n, i, o, C); break;
    case 12: chain_kernel<12><<<1, 1, 0, s>>>(n, i, o, C); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""

# k doublings of one point by a quad of lanes, nothing else: the ladder's
# doubling (msm.cu), timed apart from the kernel that uses it.
DBL_CHAIN = r"""
#include "curve.cuh"
using namespace sp2;

__global__ void dbl_chain_kernel(int k, const uint32_t* in, uint32_t* out, Curve C) {
  const Pt P = pt_dbl_quad_n<OpsCC>(pt_load(in, 0), k, C, curve_a_kind(C));
  if (threadIdx.x == 0) pt_store(out, 0, P);
}

extern "C" int sp2_dbl_chain(int k, const void* in, void* out,
                             const uint32_t* curve_words, void* stream) {
  dbl_chain_kernel<<<1, 4, 0, (cudaStream_t)stream>>>(
      k, (const uint32_t*)in, (uint32_t*)out, curve_from_words(curve_words));
  return (int)cudaGetLastError();
}
"""


def dbl_chain_probe():
    """A CudaKernel of DBL_CHAIN (source under build/latency_probe/), for
    ``build_all`` beside the port's kernels."""
    from spartan2_tpu_torch.utils.cuda import I, P, CudaKernel

    WORK.mkdir(parents=True, exist_ok=True)
    src = WORK / "dbl_chain.cu"
    src.write_text(DBL_CHAIN)
    probe = CudaKernel("dbl_chain", {"sp2_dbl_chain": [I, P, P, P]})
    probe.source = src
    return probe


def dbl_chain(probe, P, k: int, curve):
    """2^k P (P: (3, 8) Jacobian on the card) by the probe's k doublings."""
    from spartan2_tpu_torch.ec.comb import curve_words

    out = torch.empty_like(P)
    probe.call("sp2_dbl_chain", k, P.data_ptr(), out.data_ptr(), curve_words(curve))
    return out


def dbl_chain_floor_ms(probe, P, curve, k: int = 255, reps: int = 5) -> tuple:
    """(ms of k doublings in sequence, us of one): one doubling's latency is
    the difference of a 2k and a k chain over k, so the launch's own cost
    drops out."""
    def ms(n):
        dbl_chain(probe, P, n, curve)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            dbl_chain(probe, P, n, curve)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    us = (ms(2 * k) - ms(k)) * 1e3 / k
    return k * us / 1e3, us


NAMES = ["fe_mul", "fe_mul_cc", "3 x fe_mul", "3 x fe_mul_cc", "pt_dbl",
         "pt_dbl_k<OpsC>", "pt_dbl_k<OpsCC>", "pt_add", "pt_add_k<OpsC>",
         "pt_add_k<OpsCC>", "pt_dbl_quad_n<OpsCC>", "fe_add",
         "fe_add_cc"]
CHAIN = {0: 4000, 1: 4000, 2: 2000, 3: 2000, 11: 4000, 12: 4000}  # the rest: 256


def nvcc_build(src: Path, lib: Path) -> str:
    """nvcc as the port builds (utils/cuda.py) -> ptxas's report."""
    from spartan2_tpu_torch.utils.cuda import CSRC, NVCC_FLAGS, _nvcc

    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def registers(report: str) -> dict:
    """{mangled function: registers} from ptxas -v."""
    out, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = int(m.group(1))
    return out


def sass_counts(lib: Path) -> dict:
    """{mangled function: SASS instructions} by cuobjdump -sass."""
    cuobjdump = Path("/usr/local/cuda/bin/cuobjdump")
    proc = subprocess.run([str(cuobjdump if cuobjdump.exists() else "cuobjdump"), "-sass",
                           str(lib)], capture_output=True, text=True, check=True)
    out, fn = {}, None
    for line in proc.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = 0
        elif fn and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            if not re.search(r"\bNOP\b", line):
                out[fn] += 1
    return out


def short(mangled: str) -> str:
    """The function's name out of its mangled one."""
    m = re.match(r"_Z(\d+)", mangled)
    return mangled[m.end() : m.end() + int(m.group(1))] if m else mangled


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", nargs="*", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("curve_latency: no CUDA device", file=sys.stderr)
        return 1
    from spartan2_tpu_torch.ec.comb import curve_words
    from spartan2_tpu_torch.ec.curve import get_curve
    from spartan2_tpu_torch.ec.msm import to_jacobian

    print(card_line(), flush=True)
    WORK.mkdir(parents=True, exist_ok=True)
    src, lib = WORK / "probe.cu", WORK / "probe.so"
    src.write_text(PROBE)
    report = nvcc_build(src, lib)
    regs, sass = registers(report), sass_counts(lib)
    base = next(v for k, v in sass.items() if "one_copy" in k)
    print(json.dumps({"sass_one_op": {short(k): v - base for k, v in sass.items()
                                      if k.startswith("_Z") and "one_" in k
                                      and "one_copy" not in k},
                      "sass_copy_kernel": base,
                      "registers": {k: v for k, v in regs.items()}}), flush=True)
    for extra in args.src:
        elib = WORK / (Path(extra).stem + "_extra.so")
        rep = nvcc_build(Path(extra), elib)
        print(json.dumps({"source": extra, "registers": registers(rep),
                          "sass": sass_counts(elib)}), flush=True)

    so = ctypes.CDLL(str(lib))
    so.probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p]
    so.probe.restype = ctypes.c_int
    dev = torch.device("cuda")
    for cname in ("p256", "pallas"):
        curve = get_curve(cname)
        G = curve.generator
        pts = to_jacobian([curve.scalar_mul(5, G), curve.scalar_mul(7, G)], curve, dev)
        words = curve_words(curve)
        outs = {}
        for which, name in enumerate(NAMES):
            n = CHAIN.get(which, 256)
            out = torch.empty(3, 8, dtype=torch.int32, device=dev)

            def run():
                err = so.probe(which, n, pts.data_ptr(), out.data_ptr(), words,
                               torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"probe {name}: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                run()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 3
            outs[which] = out.clone()
            print(json.dumps({"curve": cname, "op": name, "chain": n, "ms": ms,
                              "us_per_step": ms * 1e3 / n}), flush=True)
        for a, b in ((0, 1), (2, 3), (4, 5), (4, 6), (7, 8), (7, 9), (4, 10), (11, 12)):
            if not torch.equal(outs[a], outs[b]):
                raise RuntimeError(f"{cname}: {NAMES[b]} chain differs from {NAMES[a]}")
        print(f"{cname}: every chain equals the old functions' limb for limb", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
