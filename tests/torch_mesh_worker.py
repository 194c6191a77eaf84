"""Rank functions of the port's mesh tests (tests/test_torch_mesh.py).

The ranks are spawned processes (spartan2_tpu_torch/parallel/mesh.py
``run_ranks``): this module imports torch and the port only, never JAX
nor tests/conftest.py, so a rank stays small.  The inputs are made here
from fixed seeds, so the test process makes the same ones for the
single-device provers (``sumcheck_inputs``).
"""

from __future__ import annotations

import torch

from spartan2_tpu_torch.errors import SpartanError
from spartan2_tpu_torch.provider.engines import get_engine
from spartan2_tpu_torch.sumcheck.device import eq_factors, eq_table
from spartan2_tpu_torch.transcript.device import DeviceTranscript
from spartan2_tpu_torch.transcript.transcript import Transcript
from tests.torch_helpers import ChainCircuit, CoreCircuit, det, mont_vector, rand_ints

ENGINE = "PallasHyraxEngine"
M = 7  # 2^7 rows: five sharded rounds at W = 4, six at W = 2
EFF = 99  # the outer sum-check's live rows: the peel reads 35 of 64 upper rows
K = 2  # ZK instances, as NeutronNova's step and core
COMMIT_ROWS = 5  # rows of the sharded commit: neither 2 nor 4 divides it
CHAIN_STEP_X0 = (3, 5)
CHAIN_STEP_N = 62


def sumcheck_inputs():
    """-> (spec, dict of seeded inputs for every sum-check case), on the CPU."""
    F = get_engine(ENGINE).scalar
    p = F.modulus
    n = 1 << M

    def vec(seed, rows=n, zero_from=None):
        v = mont_vector(F, rows, seed)[1]
        if zero_from is not None:
            v[zero_from:] = 0
        return v

    taus = rand_ints(p, M, 11)
    taus01 = [0, 1] + rand_ints(p, M - 2, 12)
    return F, {
        "abc": [vec(20 + i, zero_from=EFF) for i in range(3)],
        "taus": taus, "taus01": taus01,
        "claim": rand_ints(p, 1, 13)[0],
        "quad": [vec(30 + i) for i in range(2)],
        "cubic": [vec(40 + i, 1 << (M - 1)) for i in range(3)],
        "zk": [torch.stack([vec(50 + 2 * i + k, 1 << (M - 1)) for k in range(K)])
               for i in range(3)],
        "zk_E": vec(60, 1 << (M - 1)),
        "zk_claims": rand_ints(p, K, 61),
    }


def _td(F, label=b"mesh"):
    return DeviceTranscript.from_host(Transcript(F, label), "cpu")


def _zk_challenge(F, tr: Transcript):
    """A host challenge_fn: absorb every instance's polynomial, squeeze."""
    def fn(i, unis):
        for u in unis:
            tr.absorb_bytes(b"p", u.to_transcript_bytes())
        return tr.squeeze(b"c")
    return fn


def _mont(F, x: int) -> torch.Tensor:
    from spartan2_tpu_torch.field.limbs import to_device

    return to_device([x], F, "cpu", mont=True)[0]


def single_provers(F) -> dict:
    """The single-device provers, called as the sharded ones are."""
    from functools import partial

    from spartan2_tpu_torch.sumcheck.prove import (
        SumcheckProverCubic, SumcheckProverCubicEq, SumcheckProverQuad)
    from spartan2_tpu_torch.sumcheck.zk_device import prove_zk_cubic, prove_zk_quad

    return {"cubic_eq": SumcheckProverCubicEq(F).prove,
            "quad": SumcheckProverQuad(F).prove, "cubic": SumcheckProverCubic(F).prove,
            "zk_cubic": partial(prove_zk_cubic, F), "zk_quad": partial(prove_zk_quad, F)}


def sharded_provers(F, mesh) -> dict:
    from spartan2_tpu_torch.parallel.sumcheck_shard import (
        ShardedSumcheckCubic, ShardedSumcheckCubicEq, ShardedSumcheckQuad,
        ShardedZkSumcheckCubic, ShardedZkSumcheckQuad)

    return {"cubic_eq": ShardedSumcheckCubicEq(F, mesh).prove,
            "quad": ShardedSumcheckQuad(F, mesh).prove,
            "cubic": ShardedSumcheckCubic(F, mesh).prove,
            "zk_cubic": ShardedZkSumcheckCubic(F, mesh).prove,
            "zk_quad": ShardedZkSumcheckQuad(F, mesh).prove}


def run_sumchecks(F, inp, provers: dict):
    """Every sum-check case on ``provers`` (``single_provers`` or
    ``sharded_provers``) -> {case: outputs}, all on the host."""
    out = {}
    zero = torch.zeros(8, dtype=torch.int32)
    for name, taus, zc in (("gruen_peeled", inp["taus"], True),
                           ("gruen_peeled_tau01", inp["taus01"], False)):
        td = _td(F)
        v = [x.clone() for x in inp["abc"]]
        claim = zero if zc else _mont(F, inp["claim"])
        c, rs, fin, cl = provers["cubic_eq"](td, *v, claim, taus, zero_check=zc,
                                                   eff=EFF)
        out[name] = [c, rs, torch.stack(fin), cl, td.state, td.round]
    td = _td(F)
    v = [x.clone() for x in inp["quad"]]
    c, rs, fin, cl = provers["quad"](td, *v, _mont(F, inp["claim"]), M)
    out["quad"] = [c, rs, torch.stack(fin), cl, td.state, td.round]
    td = _td(F)
    eq = eq_table(eq_factors(inp["taus"][1:], F, "cpu"), F)
    v = [x.clone() for x in inp["cubic"]]
    c, rs, fin, cl = provers["cubic"](td, eq, *v, _mont(F, inp["claim"]))
    out["cubic"] = [c, rs, torch.stack(fin), cl, td.state, td.round]
    tr = Transcript(F, b"zk")
    rs, fin, e = provers["zk_cubic"](
        inp["zk_claims"], inp["zk_E"].clone(), tuple(x.clone() for x in inp["zk"]),
        _zk_challenge(F, tr))
    out["zk_cubic"] = [rs, fin, e, tr.state]
    tr = Transcript(F, b"zk")
    rs, fin = provers["zk_quad"](
        inp["zk_claims"], tuple(x.clone() for x in inp["zk"][:2]), M - 1,
        _zk_challenge(F, tr))
    out["zk_quad"] = [rs, fin, tr.state]
    return out


def sumchecks_rank(mesh):
    """Rank function: every sharded prover, the sharded commit, and a
    transcript state that differs on rank 1 (which must raise)."""
    from spartan2_tpu_torch.parallel.sumcheck_shard import (ShardedSumcheckQuad,
                                                            commit_rows_sharded)

    F, inp = sumcheck_inputs()
    out = run_sumchecks(F, inp, sharded_provers(F, mesh))
    out["gathers"] = mesh.gathers
    comb, scal = commit_inputs()
    out["commit"] = commit_rows_sharded(mesh, comb, scal)
    td = _td(F, b"mesh" if mesh.rank != 1 else b"other")
    try:
        ShardedSumcheckQuad(F, mesh).prove(td, *[x.clone() for x in inp["quad"]],
                                           _mont(F, inp["claim"]), M)
        out["disagree"] = None
    except SpartanError as exc:
        out["disagree"] = str(exc)
    draw = mesh.common_rng()
    out["draws"] = [draw(F.modulus) for _ in range(4)]
    return out


def commit_inputs():
    """A Pallas comb over four generators and COMMIT_ROWS rows of small
    seeded scalars, on the CPU."""
    from spartan2_tpu_torch.field.limbs import to_device
    from spartan2_tpu_torch.pcs.hyrax import SMALL_BITS

    engine = get_engine(ENGINE)
    ck, _ = engine.pcs.setup(b"ck", 16, 4, "cpu")
    vals = rand_ints(1 << 20, COMMIT_ROWS * 4, 70)
    scal = to_device(vals, engine.scalar, "cpu").reshape(COMMIT_ROWS, 4, 8)
    return ck.comb(SMALL_BITS), scal


def chain_spartan():
    """SpartanSNARK on ChainCircuit (Pallas, width 4) -> (prove(mesh):
    the proof bytes from prep det(1) and prove det(2), verify(bytes))."""
    from spartan2_tpu_torch.snark.spartan import SpartanSNARK
    from spartan2_tpu_torch.utils.serde import (spartan_proof_from_bytes,
                                                spartan_proof_to_bytes)

    engine = get_engine(ENGINE)
    circuit = ChainCircuit()
    pk, vk = SpartanSNARK.setup(engine, circuit, width=4, device="cpu")

    def prove(mesh):
        prep = SpartanSNARK.prep_prove(pk, circuit, rng=det(1))
        proof, _ = SpartanSNARK.prove(pk, circuit, prep, rng=det(2), mesh=mesh)
        return spartan_proof_to_bytes(proof, engine)

    def verify(blob):
        proof = spartan_proof_from_bytes(blob, engine)
        return SpartanSNARK.verify(proof, vk) == circuit.public_values()

    return prove, verify


def chain_neutronnova():
    """NeutronNovaZkSNARK on two ChainSteps and the Core (Pallas, width 4)
    -> (prove(mesh), verify(bytes)) as ``chain_spartan``."""
    from spartan2_tpu_torch.snark.neutronnova import NeutronNovaZkSNARK as NN
    from spartan2_tpu_torch.utils.serde import (neutronnova_proof_from_bytes,
                                                neutronnova_proof_to_bytes)

    engine = get_engine(ENGINE)
    steps = [ChainCircuit(x0, CHAIN_STEP_N) for x0 in CHAIN_STEP_X0]
    core = CoreCircuit()
    pk, vk = NN.setup(engine, steps[0], core, len(steps), width=4, device="cpu")

    def prove(mesh):
        prep = NN.prep_prove(pk, steps, core, rng=det(1))
        proof, _ = NN.prove(pk, steps, core, prep, rng=det(2), mesh=mesh)
        return neutronnova_proof_to_bytes(proof, engine)

    def verify(blob):
        proof = neutronnova_proof_from_bytes(blob, engine)
        return NN.verify(proof, vk, len(steps)) == ([s.public_values() for s in steps],
                                                     core.public_values())

    return prove, verify


def chain_rank(mesh, name: str):
    """Rank function: the chain proof on ``mesh`` and on its half that
    holds this rank (ranks [0, W/2) and [W/2, W)); the last rank also
    proves on one device, the one before it verifies the mesh's proof."""
    import torch.distributed as dist

    from spartan2_tpu_torch.parallel.mesh import Mesh

    prove, verify = {"spartan": chain_spartan, "neutronnova": chain_neutronnova}[name]()
    h = mesh.size // 2
    groups = [dist.new_group(list(range(a, a + h))) for a in (0, h)]
    half = Mesh(groups[mesh.rank // h], device=mesh.device)
    out = {"mesh": prove(mesh), "half": prove(half)}
    if mesh.rank == mesh.size - 1:
        out["single"] = prove(None)
    if mesh.rank == mesh.size - 2:
        out["verifies"] = verify(out["mesh"])
    return out
