"""Engines: curve + scalar field + transcript + PCS bundles.

Reference: src/provider/mod.rs:33-90.  As in the JAX package, the T256
curve's constants are not public, so P256HyraxEngine is the 256-bit
benchmark engine (ec/curve.py).  An engine holds no device state: the
device is chosen when the keys are made (snark/spartan.py).
"""

from __future__ import annotations

import functools

from ..ec.curve import CurveSpec, get_curve
from ..field.constants import FieldSpec
from ..pcs.hyrax import HyraxPCS
from ..transcript.transcript import Transcript


class Engine:
    """Ties base field, scalar field, group, transcript and PCS together
    (reference traits/mod.rs:37-61)."""

    def __init__(self, curve_name: str):
        self.name = curve_name
        self.curve: CurveSpec = get_curve(curve_name)
        self.scalar: FieldSpec = self.curve.scalar
        self.base: FieldSpec = self.curve.base
        self.pcs = HyraxPCS(self.curve)

    def transcript(self, label: bytes) -> Transcript:
        return Transcript(self.scalar, label)


@functools.lru_cache(maxsize=None)
def get_engine(name: str) -> Engine:
    table = {
        "PallasHyraxEngine": "pallas",
        "VestaHyraxEngine": "vesta",
        "P256HyraxEngine": "p256",
        "Bn254Engine": "bn254",
    }
    return Engine(table.get(name, name))
