"""The host C libraries, built at first use and loaded through ctypes.

``keccak.c`` (the host Keccak-256) and ``ec_host.c`` (the host curve:
Pippenger MSM and windowed scalar multiplication) are each compiled with
``cc -O3 -shared -fPIC`` into ``build/native/`` at the root of the
checkout (git-ignored, beside the CUDA kernels' ``build/kernels/``),
keyed by a hash of the source.  A failed build raises with the
compiler's message: there is no silent fallback to Python
(transcript/keccak.py and ec/curve.py keep their Python versions only as
the plain versions the tests compare with).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CC = "cc"


def _build(src_name: str) -> Path:
    src = SRC_DIR / src_name
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"{src.stem}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        out = subprocess.run([CC, "-O3", "-shared", "-fPIC", "-o", tmp, str(src)],
                             capture_output=True, text=True)
    except OSError as exc:
        os.unlink(tmp)
        raise RuntimeError(f"{CC} failed for {src_name}: {exc}") from exc
    if out.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{CC} failed for {src_name}:\n{out.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builders agree
    return lib


def load_keccak():
    """-> keccak256(data: bytes) -> 32 bytes, from the C library."""
    fn = ctypes.CDLL(str(_build("keccak.c"))).sp2_keccak256
    fn.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]
    fn.restype = None

    def keccak256(data: bytes) -> bytes:
        out = ctypes.create_string_buffer(32)
        fn(bytes(data), len(data), out)
        return out.raw

    return keccak256


def load_ec():
    """-> (msm, scalar_mul) over byte buffers, from the C library.

    msm(params: 13 x u64 bytes, scalars: 32n bytes, points: 64n bytes,
        n) -> 96 bytes, Jacobian X || Y || Z canonical (Z == 0: identity);
    scalar_mul(params, k: 32 bytes, point: 64 bytes) -> 96 bytes.
    Scalars and coordinates are little-endian; the point (0, 0) is the
    identity.
    """
    lib = ctypes.CDLL(str(_build("ec_host.c")))
    fmsm = lib.sp2_ec_msm
    u64p = ctypes.POINTER(ctypes.c_uint64)
    fmsm.argtypes = [u64p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
                     ctypes.c_char_p]
    fmsm.restype = None
    fmul = lib.sp2_ec_scalar_mul
    fmul.argtypes = [u64p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
    fmul.restype = None
    u64x13 = ctypes.c_uint64 * 13

    def msm(params: bytes, scalars: bytes, points: bytes, n: int) -> bytes:
        if len(params) != 13 * 8 or len(scalars) != 32 * n or len(points) != 64 * n:
            raise ValueError("msm: 104 parameter bytes, 32 bytes a scalar, 64 a point")
        out = ctypes.create_string_buffer(96)
        fmsm(u64x13.from_buffer_copy(params), scalars, points, n, out)
        return out.raw

    def scalar_mul(params: bytes, k: bytes, point: bytes) -> bytes:
        if len(params) != 13 * 8 or len(k) != 32 or len(point) != 64:
            raise ValueError("scalar_mul: 104 parameter bytes, a 32-byte scalar, "
                             "a 64-byte point")
        out = ctypes.create_string_buffer(96)
        fmul(u64x13.from_buffer_copy(params), k, point, out)
        return out.raw

    return msm, scalar_mul
