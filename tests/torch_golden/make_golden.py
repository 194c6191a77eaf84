"""Record JAX reference runs: SpartanSNARK and SpartanZkSNARK on the
cubic circuit, NeutronNovaZkSNARK, the mesh tests' chain circuits, and
the device curve and multilinear functions that no prove calls.

The port's byte-identity tests (tests/test_torch_spartan.py,
tests/test_torch_spartan_zk.py) load the keys and the prep state written
here, prove with the port from the same seeds, and compare the serialized
proof with the JAX proof stored here.  A JAX prove compiles its device
programs on XLA:CPU for tens of minutes, so the reference side is
recorded once and committed.

Run from the repository root:

    JAX_PLATFORMS=cpu python -m tests.torch_golden.make_golden        # cubic_p256.bin
    JAX_PLATFORMS=cpu python -m tests.torch_golden.make_golden --zk   # cubic_zk_p256.bin
    JAX_PLATFORMS=cpu python -m tests.torch_golden.make_golden --vesta  # cubic_vesta.bin
    JAX_PLATFORMS=cpu python -m tests.torch_golden.make_golden --bn254  # cubic_bn254.bin
    SPARTAN2_NN_HOST=1 JAX_PLATFORMS=cpu python -m tests.torch_golden.make_golden --nn
    SPARTAN2_NN_HOST=1 JAX_PLATFORMS=cpu python -m tests.torch_golden.make_golden --nn square
    JAX_PLATFORMS=cpu python -m tests.torch_golden.make_golden --chain      # chain_pallas.bin
    SPARTAN2_NN_HOST=1 JAX_PLATFORMS=cpu python -m tests.torch_golden.make_golden --chain-nn
    JAX_PLATFORMS=cpu python -m tests.torch_golden.make_golden --curve      # curve_device.json

The committed ``cubic_p256.bin`` was recorded with the JAX package of
commit 4cf6d4bc4a04b6b518ace38bd3ac5e0ff6d2cd09, and ``cubic_zk_p256.bin``
(through JAX's default device path) with the JAX package of commit
e26eee5ee9a12d44319e1936090806f3e64ac20b.  ``cubic_vesta.bin`` and
``cubic_bn254.bin`` hold the same SpartanSNARK run on ``VestaHyraxEngine``
and ``Bn254Engine``, recorded with the JAX package of commit
93cffdab363a293799a7b1bbe5c215cf081c8329 in 1929 s and 2028 s, one after
the other (about 16 GB each).

The NeutronNovaZkSNARK files hold one configuration each, both P256 at
width 4 with tests/test_neutronnova.py's ``CoreCircuit`` as the core:
``nn_square_p256.bin`` folds 3 ``SquareStepCircuit`` steps (x = 2, 5, 11;
pads to 4, non-empty rest segment), ``nn_precommitted_p256.bin`` folds 7
``PrecommittedStepCircuit`` steps (x = 2, 3, 5, 7, 11, 13, 17; pads to 8,
truncated-rest fold, small-value NIFS round 0).  Both were recorded
with the JAX package of commit 6c885122a9d3f75f5c8d47b1995fd3d2ca1bdfe9
through its host NeutronNova path (SPARTAN2_NN_HOST=1, set in the
recording process only).  Through the default device path, three
recordings (each beside another) died after 13-53 minutes of XLA:CPU
compiles with LLVM "Cannot allocate memory" errors.  The JAX package
keeps the host path to cross-test the device path; the port follows the
device path and proves to these bytes.

The two Pallas chain files hold tests/test_mesh.py's configurations,
which the JAX package proves on its 8-device CPU mesh and holds equal to
its single-device proofs: ``chain_pallas.bin`` is SpartanSNARK on
``ChainCircuit`` (x -> x^2 a thousand times from x = 3, the last value
public; PallasHyraxEngine, width 4), ``nn_chain_pallas.bin`` is
NeutronNovaZkSNARK on two ``ChainStep`` circuits (62 squarings from
x = 3 and x = 5) with ``Core`` (y = 6 * 7).  They are recorded here from
the JAX package's single-device provers; the port's mesh tests
(tests/test_torch_mesh.py) prove to these bytes on W ranks.

``curve_device.json`` holds the JAX package's four device curve and
multilinear functions, which no JAX prove calls, on P-256 and Pallas:
``DeviceCurve.msm_binary`` over 8 points, over 5 (padded to 8) and over 5
with no bit set; ``msm_points_per_lane`` over 8 lanes at nbits 264 (with
the scalars 0, q - 1 and 1) and 64 (with a zero); ``scalar_mul_host_base``
with k in {0, 1, q - 1, random} over 5 points; ``mle_evaluate_device`` of
a table of 2^3 at a point of 3 coordinates.  Inputs come from
numpy's default_rng(8) and from_label(b"curve_device_golden", 8); they
are stored beside the outputs (affine points, null for the identity;
canonical field elements), so the port's tests (tests/
test_torch_curve_device.py) compile nothing.  Recorded with the JAX
package of commit 75f2a7b9b871e98a30ce4be4ff5788a989024a42 in 959.1 s,
nearly all of it XLA:CPU compiles of the per-lane ladders, in one process
that grew to about 12 GB.

Proof file layout (all integers u64 little-endian):
    b"SP2GOLD1", width, prep_seed, prove_seed,
    then three length-prefixed blobs: key bytes, prep bytes, proof bytes.
"""

from __future__ import annotations

import json
import os
import random
import struct
import sys
import time

MAGIC = b"SP2GOLD1"
WIDTH = 4
PREP_SEED = 1
PROVE_SEED = 2
HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "cubic_p256.bin")
OUT_ZK = os.path.join(HERE, "cubic_zk_p256.bin")
# SpartanSNARK on the cubic circuit with the other engines (--vesta, --bn254)
ENGINE_OUT = {"vesta": ("VestaHyraxEngine", os.path.join(HERE, "cubic_vesta.bin")),
              "bn254": ("Bn254Engine", os.path.join(HERE, "cubic_bn254.bin"))}
CHAIN_OUT = os.path.join(HERE, "chain_pallas.bin")
NN_CHAIN_OUT = os.path.join(HERE, "nn_chain_pallas.bin")
CURVE_OUT = os.path.join(HERE, "curve_device.json")
CURVE_SEED = 8
CURVE_NAMES = ("p256", "pallas")
CURVE_N = 8  # points of the per-lane and the full binary recordings
CURVE_N_PAD = 5  # points of the padded binary and the host-base recordings
CURVE_M = 3  # variables of the MLE evaluation
CHAIN_N = 1000  # ChainCircuit's squarings (tests/test_mesh.py)
CHAIN_STEP_N = 62  # ChainStep's squarings
CHAIN_STEP_X0 = [3, 5]
NN_STEPS = {"square": [2, 5, 11], "precommitted": [2, 3, 5, 7, 11, 13, 17]}


def nn_path(name: str) -> str:
    return os.path.join(HERE, f"nn_{name}_p256.bin")


def det(seed: int):
    """bench.py's deterministic blind source: rng(q) -> int in [0, q)."""
    r = random.Random(seed)
    return lambda q: r.randrange(q)


def write_golden(path: str, keys: bytes, prep: bytes, proof: bytes) -> None:
    out = bytearray(MAGIC)
    out += struct.pack("<QQQ", WIDTH, PREP_SEED, PROVE_SEED)
    for blob in (keys, prep, proof):
        out += struct.pack("<Q", len(blob)) + blob
    with open(path, "wb") as f:
        f.write(bytes(out))


def read_golden(path: str = OUT) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != MAGIC:
        raise ValueError("not a golden file")
    width, prep_seed, prove_seed = struct.unpack_from("<QQQ", data, 8)
    pos = 32
    blobs = []
    for _ in range(3):
        (n,) = struct.unpack_from("<Q", data, pos)
        blobs.append(data[pos + 8 : pos + 8 + n])
        pos += 8 + n
    if pos != len(data):
        raise ValueError("trailing bytes in golden file")
    return {"width": width, "prep_seed": prep_seed, "prove_seed": prove_seed,
            "keys": blobs[0], "prep": blobs[1], "proof": blobs[2]}


def jax_cubic_circuit():
    """x^3 + x + 5 = y with y = 15 public, on the JAX frontend."""
    from spartan2_tpu.frontend.constraint_system import ONE, Num, lc

    class CubicCircuit:
        def public_values(self):
            return [15]

        def shared(self, cs):
            return []

        def precommitted(self, cs, shared):
            return []

        def num_challenges(self):
            return 0

        def synthesize(self, cs, shared, precommitted, challenges):
            x = Num.alloc(cs, 2)
            x_sq = x.square(cs)
            x_cu = x_sq.mul(cs, x)
            y = Num.alloc(cs, None if cs.shape_mode
                          else (x_cu.value + x.value + 5) % cs.field.modulus)
            cs.enforce(lc((1, x_cu.var), (1, x.var), (5, ONE)), lc((1, ONE)),
                       lc((1, y.var)))
            y.inputize(cs)

    return CubicCircuit()


def jax_prove(zk: bool = False,
              engine_name: str = "P256HyraxEngine") -> tuple[bytes, bytes, bytes]:
    """JAX setup, prep_prove and prove from the fixed seeds, with
    SpartanSNARK or (``zk``) SpartanZkSNARK, on ``engine_name``."""
    from spartan2_tpu.provider.engines import get_engine
    from spartan2_tpu.utils import serde

    if zk:
        from spartan2_tpu.snark.spartan_zk import SpartanZkSNARK as snark
        keys_to_bytes = serde.spartan_zk_keys_to_bytes
        proof_to_bytes = serde.spartan_zk_proof_to_bytes
    else:
        from spartan2_tpu.snark.spartan import SpartanSNARK as snark
        keys_to_bytes = serde.spartan_keys_to_bytes
        proof_to_bytes = serde.spartan_proof_to_bytes

    engine = get_engine(engine_name)
    circuit = jax_cubic_circuit()
    pk, _ = snark.setup(engine, circuit, width=WIDTH)
    prep = snark.prep_prove(pk, circuit, rng=det(PREP_SEED))
    keys = keys_to_bytes(pk)
    prep_b = serde.spartan_prep_to_bytes(prep, engine)
    proof, _ = snark.prove(pk, circuit, prep, rng=det(PROVE_SEED))
    return keys, prep_b, proof_to_bytes(proof, engine)


def jax_nn_prove(name: str) -> tuple[bytes, bytes, bytes]:
    """JAX NeutronNovaZkSNARK setup, prep_prove and prove of the ``name``
    configuration from the fixed seeds."""
    from spartan2_tpu.provider.engines import get_engine
    from spartan2_tpu.snark.neutronnova import NeutronNovaZkSNARK as snark
    from spartan2_tpu.utils import serde
    from tests.test_neutronnova import (
        CoreCircuit,
        PrecommittedStepCircuit,
        SquareStepCircuit,
    )

    step_cls = {"square": SquareStepCircuit,
                "precommitted": PrecommittedStepCircuit}[name]
    engine = get_engine("P256HyraxEngine")
    steps = [step_cls(x) for x in NN_STEPS[name]]
    core = CoreCircuit()
    pk, _ = snark.setup(engine, steps[0], core, len(steps), width=WIDTH)
    prep = snark.prep_prove(pk, steps, core, rng=det(PREP_SEED))
    keys = serde.neutronnova_keys_to_bytes(pk, len(steps))
    prep_b = serde.neutronnova_prep_to_bytes(prep, engine)
    proof, _ = snark.prove(pk, steps, core, prep, rng=det(PROVE_SEED))
    return keys, prep_b, serde.neutronnova_proof_to_bytes(proof, engine)


def jax_chain_circuits():
    """tests/test_mesh.py's ChainCircuit, ChainStep and Core on the JAX
    frontend -> (ChainCircuit, ChainStep class, Core)."""
    from spartan2_tpu.frontend.constraint_system import Num
    from spartan2_tpu.provider.engines import get_engine

    p = get_engine("PallasHyraxEngine").scalar.modulus

    class Chain:
        def __init__(self, x0, n):
            self.x0, self.n = x0, n

        def public_values(self):
            x = self.x0
            for _ in range(self.n):
                x = x * x % p
            return [x]

        def shared(self, cs):
            return []

        def precommitted(self, cs, shared):
            return []

        def num_challenges(self):
            return 0

        def synthesize(self, cs, shared, precommitted, challenges):
            x = Num.alloc(cs, self.x0)
            for _ in range(self.n):
                x = x.square(cs)
            x.inputize(cs)

    class Core:
        def public_values(self):
            return [42]

        def shared(self, cs):
            return []

        def precommitted(self, cs, shared):
            return []

        def num_challenges(self):
            return 0

        def synthesize(self, cs, shared, precommitted, challenges):
            a = Num.alloc(cs, 6)
            b = Num.alloc(cs, 7)
            a.mul(cs, b).inputize(cs)

    return Chain(3, CHAIN_N), (lambda x0: Chain(x0, CHAIN_STEP_N)), Core()


def jax_chain_prove(nn: bool) -> tuple[bytes, bytes, bytes]:
    """The JAX package's single-device SpartanSNARK on ChainCircuit, or
    (``nn``) NeutronNovaZkSNARK on the two ChainSteps and Core, from the
    fixed seeds."""
    from spartan2_tpu.provider.engines import get_engine
    from spartan2_tpu.utils import serde

    engine = get_engine("PallasHyraxEngine")
    chain, step, core = jax_chain_circuits()
    if nn:
        from spartan2_tpu.snark.neutronnova import NeutronNovaZkSNARK as snark

        steps = [step(x0) for x0 in CHAIN_STEP_X0]
        pk, _ = snark.setup(engine, steps[0], core, len(steps), width=WIDTH)
        prep = snark.prep_prove(pk, steps, core, rng=det(PREP_SEED))
        keys = serde.neutronnova_keys_to_bytes(pk, len(steps))
        prep_b = serde.neutronnova_prep_to_bytes(prep, engine)
        proof, _ = snark.prove(pk, steps, core, prep, rng=det(PROVE_SEED))
        return keys, prep_b, serde.neutronnova_proof_to_bytes(proof, engine)
    from spartan2_tpu.snark.spartan import SpartanSNARK as snark

    pk, _ = snark.setup(engine, chain, width=WIDTH)
    prep = snark.prep_prove(pk, chain, rng=det(PREP_SEED))
    keys = serde.spartan_keys_to_bytes(pk)
    prep_b = serde.spartan_prep_to_bytes(prep, engine)
    proof, _ = snark.prove(pk, chain, prep, rng=det(PROVE_SEED))
    return keys, prep_b, serde.spartan_proof_to_bytes(proof, engine)


def _affine_json(pts) -> list:
    return [None if pt is None else [hex(pt[0]), hex(pt[1])] for pt in pts]


def jax_curve_record() -> dict:
    """The JAX package's four device curve and multilinear functions
    (DeviceCurve.msm_binary, msm_points_per_lane at nbits 264 and 64,
    scalar_mul_host_base; mle_evaluate_device) on P-256 and Pallas, from
    numpy-seeded inputs: inputs as canonical ints, outputs as affine
    points (null for the identity) or canonical field elements."""
    import jax.numpy as jnp
    import numpy as np

    from spartan2_tpu.ec.curve import get_curve
    from spartan2_tpu.ec.device import DeviceCurve
    from spartan2_tpu.field.jnp_ops import FieldOps
    from spartan2_tpu.field.limbs import ints_to_limbs_np, limbs_to_ints
    from spartan2_tpu.polys.multilinear import mle_evaluate_device, mle_evaluate_host

    rng = np.random.default_rng(CURVE_SEED)

    def below(bound: int, n: int) -> list[int]:
        return [int.from_bytes(rng.bytes(40), "little") % bound for _ in range(n)]

    out = {}
    for name in CURVE_NAMES:
        c = get_curve(name)
        dc, q = DeviceCurve(c), c.scalar.modulus
        pts = c.from_label(b"curve_device_golden", CURVE_N)

        def dev(points):
            return (jnp.asarray(ints_to_limbs_np([p[0] for p in points], c.base, mont=True)),
                    jnp.asarray(ints_to_limbs_np([p[1] for p in points], c.base, mont=True)))

        Qx, Qy = dev(pts)
        Px, Py = dev(pts[:CURVE_N_PAD])
        rec = {"points": _affine_json(pts), "binary": [], "per_lane": [],
               "host_base": []}
        bits8 = [int(b) for b in rng.integers(0, 2, CURVE_N)]
        bits5 = [1, 0, 1, 1, 0]
        for bits, (x, y) in ((bits8, (Qx, Qy)), (bits5, (Px, Py)),
                             ([0] * CURVE_N_PAD, (Px, Py))):
            got = dc.msm_binary(jnp.asarray(np.array(bits, np.int32)), x, y)
            rec["binary"].append({"bits": bits,
                                  "out": _affine_json(dc.to_affine_host(got))[0]})
        full = below(q, CURVE_N)
        full[1], full[2], full[3] = 0, q - 1, 1
        small = below(1 << 64, CURVE_N)
        small[4] = 0
        for scal, nbits in ((full, 264), (small, 64)):
            sc = jnp.asarray(ints_to_limbs_np(scal, c.scalar, mont=False))
            got = dc.msm_points_per_lane(sc, Qx, Qy, nbits)
            rec["per_lane"].append({"nbits": nbits, "scalars": [hex(v) for v in scal],
                                    "out": _affine_json(dc.to_affine_host(got))})
        for k in (0, 1, q - 1, below(q, 1)[0]):
            got = dc.scalar_mul_host_base(k, Px, Py)
            rec["host_base"].append({"k": hex(k),
                                     "out": _affine_json(dc.to_affine_host(got))})
        F = c.scalar
        table, r = below(F.modulus, 1 << CURVE_M), below(F.modulus, CURVE_M)
        got = mle_evaluate_device(
            FieldOps(F), jnp.asarray(ints_to_limbs_np(table, F, mont=True)),
            jnp.asarray(ints_to_limbs_np(r, F, mont=True)))
        rec["mle"] = {"table": [hex(v) for v in table], "r": [hex(v) for v in r],
                      "out": hex(limbs_to_ints(np.asarray(got), F, mont=True)[0]),
                      "host": hex(mle_evaluate_host(F, table, r))}
        out[name] = rec
    return out


def main() -> int:
    args = sys.argv[1:]
    if "--curve" in args:
        t0 = time.time()
        rec = jax_curve_record()
        with open(CURVE_OUT, "w") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")
        print(f"wrote {CURVE_OUT} in {time.time() - t0:.1f} s")
        return 0
    for flag, out, nn in (("--chain", CHAIN_OUT, False),
                          ("--chain-nn", NN_CHAIN_OUT, True)):
        if flag in args:
            t0 = time.time()
            keys, prep, proof = jax_chain_prove(nn)
            write_golden(out, keys, prep, proof)
            print(f"wrote {out}: keys {len(keys)} B, prep {len(prep)} B, "
                  f"proof {len(proof)} B in {time.time() - t0:.1f} s")
            return 0
    if "--nn" in args:
        rest = args[args.index("--nn") + 1:]
        for name in rest[:1] or list(NN_STEPS):
            t0 = time.time()
            keys, prep, proof = jax_nn_prove(name)
            write_golden(nn_path(name), keys, prep, proof)
            print(f"wrote {nn_path(name)}: keys {len(keys)} B, prep "
                  f"{len(prep)} B, proof {len(proof)} B in "
                  f"{time.time() - t0:.1f} s")
        return 0
    zk = "--zk" in args
    out, engine_name = OUT_ZK if zk else OUT, "P256HyraxEngine"
    for name, (eng, path) in ENGINE_OUT.items():
        if f"--{name}" in args:
            out, engine_name = path, eng
    t0 = time.time()
    keys, prep, proof = jax_prove(zk, engine_name)
    write_golden(out, keys, prep, proof)
    print(f"wrote {out}: keys {len(keys)} B, prep {len(prep)} B, "
          f"proof {len(proof)} B in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
