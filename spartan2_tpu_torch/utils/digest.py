"""Verifier-key digests (reference: src/digest.rs DigestComputer).

SHA-256 over a deterministic serialization of the verifier key: shape
dimensions, the three CSR matrices, and the commitment-key generators.
The byte layout differs from the reference's bincode stream (we do not
target bit-identical keys), but serves the same role: binding every
transcript to the exact key via the b"vk" absorb (spartan.rs:226-229).
"""

from __future__ import annotations

import hashlib


def vk_digest(shape, ck, ck_s) -> bytes:
    h = hashlib.sha256()
    for dim in shape.sizes():
        h.update(int(dim).to_bytes(8, "little"))
    h.update(shape.A.digest_bytes())
    h.update(shape.B.digest_bytes())
    h.update(shape.C.digest_bytes())
    for key in (ck, ck_s):
        h.update(len(key.ck).to_bytes(8, "little"))
        for pt in key.ck:
            h.update(key.curve.point_bytes(pt))
        h.update(key.curve.point_bytes(key.h))
    return h.digest()
