"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded through ``ctypes``.
The build runs at first use, into ``build/kernels/`` at the root of the
checkout (git-ignored), keyed by a hash of the sources and flags.
``build_all`` starts one ``nvcc`` per source at once.

Every kernel wrapper in the port holds a ``CudaKernel`` and adds one to
its ``launches`` where it calls into the library, and nowhere else; the
count is also kept per C entry (``entry_launches``), for a source whose
entries serve more than one kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
SZ = ctypes.c_size_t


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


class CudaKernel:
    """One CUDA source, its C entry points and a launch count."""

    def __init__(self, name: str, entries: dict):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.entries = entries  # C function name -> argtypes before the stream
        self.launches = 0
        self.entry_launches: dict[str, int] = {}
        self._lib = None

    def reset(self) -> None:
        """Set the launch counts to 0."""
        self.launches = 0
        self.entry_launches = {}

    def _key(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in (self.source, *sorted(CSRC.glob("*.cuh"))):
            h.update(f.read_bytes())
        return h.hexdigest()[:16]

    @property
    def lib_path(self) -> Path:
        return BUILD_DIR / f"{self.name}-{self._key()}.so"

    def start_build(self):
        """Start nvcc unless the library exists; -> (Popen, tmp, log) or None."""
        if self.lib_path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        log = BUILD_DIR / f"{self.name}.log"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(self.source)]
        with open(log, "w") as lf:
            proc = subprocess.Popen(cmd, stdout=lf, stderr=subprocess.STDOUT)
        return proc, tmp, log

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp, log = started
        if proc.wait() != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n"
                               + Path(log).read_text())
        os.replace(tmp, self.lib_path)

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.lib_path))
            for fn, argtypes in self.entries.items():
                f = getattr(lib, fn)
                f.argtypes = [*argtypes, P]  # every entry ends with the stream
                f.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args) -> None:
        """Launch through entry ``fn`` on the current stream and count it;
        raise if the launch was refused."""
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(self.lib(), fn)(*args, stream)
        self.launches += 1
        self.entry_launches[fn] = self.entry_launches.get(fn, 0) + 1
        if err != 0:
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {err}")


def build_all(kernels) -> float:
    """Build every kernel's library in parallel; -> seconds taken."""
    t0 = time.perf_counter()
    started = [(k, k.start_build()) for k in kernels]
    for k, s in started:
        k.finish_build(s)
    for k in kernels:
        k.lib()
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def field_words(spec) -> bytes:
    """p, Montgomery one, -p^-1 mod 2^32, R^2 and R^3 mod p as 33 u32
    (csrc/field.cuh ``Field``)."""
    p = spec.modulus

    def w8(v):
        return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]

    words = w8(p) + w8(spec.r_mod) + [spec.n0] + w8(spec.r2_mod)
    words += w8(spec.r2_mod * spec.r_mod % p)
    return struct.pack("<33I", *words)


def fe_words(value: int) -> bytes:
    """One field element (already in the wanted form) as 8 u32."""
    return int(value).to_bytes(32, "little")


def check_cuda(*tensors: torch.Tensor, dtype=torch.int32) -> None:
    """A kernel takes contiguous int32 tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("kernel inputs must lie on one CUDA device")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"kernel inputs must be contiguous {dtype}")
        if t.data_ptr() % 16:
            raise ValueError("kernel inputs must be 16-byte aligned")
