"""The host Keccak-256 in C, built at first use and loaded through ctypes.

``keccak.c`` is compiled with ``cc -O3 -shared -fPIC`` into
``build/native/`` at the root of the checkout (git-ignored, beside the
CUDA kernels' ``build/kernels/``), keyed by a hash of the source.  A
failed build raises with the compiler's message: there is no silent
fallback to the pure-Python Keccak (transcript/keccak.py keeps it only
as the plain version the tests compare with).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parent / "keccak.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"


def _build() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"keccak-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    out = subprocess.run(["cc", "-O3", "-shared", "-fPIC", "-o", tmp, str(SRC)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"cc failed for {SRC.name}:\n{out.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builders agree
    return lib


def load_keccak():
    """-> keccak256(data: bytes) -> 32 bytes, from the C library."""
    fn = ctypes.CDLL(str(_build())).sp2_keccak256
    fn.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]
    fn.restype = None

    def keccak256(data: bytes) -> bytes:
        out = ctypes.create_string_buffer(32)
        fn(bytes(data), len(data), out)
        return out.raw

    return keccak256
