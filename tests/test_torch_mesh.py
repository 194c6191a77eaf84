"""The port's multi-device path (spartan2_tpu_torch/parallel/) on the CPU:
W ranks in a gloo group, spawned processes on the plain versions.

Every sharded prover must give the single-device prover's messages byte
for byte (coefficients, challenges, finals, claim, transcript state), the
peeled outer round 0 with tau_0 = 0 and tau_1 = 1 included, and the two
chain configurations of the JAX package's mesh tests (tests/test_mesh.py,
PallasHyraxEngine, width 4, prep det(1), prove det(2)) must prove to the
single-device proof and to the JAX package's recorded single-device proof
(tests/torch_golden/chain_pallas.bin, nn_chain_pallas.bin).  Tolerance 0.
The rank functions live in tests/torch_mesh_worker.py, which imports no
JAX; each run of ranks has a deadline and ends its ranks on overrun.
"""

import os

import pytest
import torch

from spartan2_tpu_torch.field import ops
from spartan2_tpu_torch.field.limbs import limbs_to_ints, to_device
from spartan2_tpu_torch.parallel.mesh import SeededDraws, run_ranks
from spartan2_tpu_torch.polys.eq import eq_evals_host
from spartan2_tpu_torch.sumcheck.device import cubiceq_evals, cubiceq_evals_plain
from tests import torch_mesh_worker as worker
from tests.torch_golden.make_golden import CHAIN_OUT, NN_CHAIN_OUT, read_golden
from tests.torch_helpers import mont_vector, rand_ints

DEADLINE = 300  # seconds for one run of ranks, rendezvous included


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("s", ["first", "last"])
def test_kernel_g_strided_equals_unstrided_on_global_rows(W, s):
    """Kernel G's plain strided mode on rank s's rows (global rows s + W i)
    of the peeled round 0 and of a two-level round: the ranks' sums add
    up to the unstrided sums over all rows, and each rank's equal the
    unstrided sums over its rows with its weights moved into place."""
    F = worker.sumcheck_inputs()[0]
    p = F.modulus
    m, eff = 8, 201
    n = 1 << m
    A, B, C = (mont_vector(F, n, 80 + i)[1] for i in range(3))
    for v in (A, B, C):
        v[eff:] = 0
    taus = [0] + rand_ints(p, m - 1, 84)
    fh = m // 2
    EL = to_device(eq_evals_host(F, taus[1:fh]), F, "cpu", mont=True)
    ER = to_device(eq_evals_host(F, taus[fh:]), F, "cpu", mont=True)
    rank = 0 if s == "first" else W - 1
    lw = W.bit_length() - 1
    for half, hi_len, zc, fb in ((n // 2, eff - n // 2, True, True),
                                 (n // 4, n // 4, False, False)):
        want = cubiceq_evals_plain(A, B, C, half, hi_len, EL, ER, m - fh, zc, fb, F)
        total = None
        for r in range(W):
            loc = [torch.cat([v[:half][r::W], v[half : 2 * half][r::W]]) for v in (A, B, C)]
            live = min(half // W, max(0, -(-(hi_len - r) // W)))
            got = cubiceq_evals(*loc, half // W, live, EL, ER, m - fh, zc, fb, F, r, lw)
            total = got if total is None else ops.add(total, got, F)
            if r == rank:
                # the same sums by the unstrided mode, weights at the rank's rows
                g = torch.arange(r, half, W)
                w = ops.mont_mul(EL[g >> (m - fh)], ER[g & ((1 << (m - fh)) - 1)], F)
                ref = cubiceq_evals_plain(*loc, half // W, live, None, w, 0, zc, fb, F)
                assert torch.equal(got, ref)
        assert limbs_to_ints(total[0], F, mont=True) == limbs_to_ints(want[0], F, mont=True)


@pytest.mark.parametrize("W", [2, 4])
def test_sharded_sumchecks_equal_single_device(W):
    """Each sharded prover against its single-device prover, at W ranks:
    the Gruen outer sum-check peeled (zero_check, and tau_0 = 0, tau_1 = 1),
    the inner quad rounds, the explicit-eq cubic, the ZK cubic and quad
    over two instances; the row-sharded comb commit over 5 rows (W does
    not divide it); a rank whose transcript state differs makes every
    rank raise; the common blind source draws alike on every rank."""
    F, inp = worker.sumcheck_inputs()
    single = worker.run_sumchecks(F, inp, worker.single_provers(F))
    comb, scal = worker.commit_inputs()
    from spartan2_tpu_torch.ec.comb import comb_rows

    want_commit = comb_rows(scal, comb.table, comb.curve)
    res = run_ranks(worker.sumchecks_rank, W, device="cpu", timeout=DEADLINE)
    assert len(res) == W
    for r, out in enumerate(res):
        for case, want in single.items():
            assert _same(out[case], want), (r, case)
        assert torch.equal(out["commit"], want_commit), r
        assert out["disagree"] is not None and "differs across the ranks" in out["disagree"]
        assert out["draws"] == res[0]["draws"]
        # the seven sum-checks gather once a sharded round, then the rows
        # once (the ZK cubic twice) and the state or challenges once
        assert out["gathers"] > 0
    assert len(set(res[0]["draws"])) == len(res[0]["draws"])


def test_seeded_draws_are_below_q_and_repeat_from_the_seed():
    a, b = SeededDraws(b"s" * 32), SeededDraws(b"s" * 32)
    q = (1 << 255) - 19
    xs = [a(q) for _ in range(50)]
    assert xs == [b(q) for _ in range(50)]
    assert all(0 <= x < q for x in xs) and len(set(xs)) == 50
    assert SeededDraws(b"t" * 32)(q) != xs[0]


def _chain(name: str, golden_path: str):
    res = run_ranks(worker.chain_rank, 4, (name,), device="cpu", timeout=DEADLINE)
    last = res[-1]
    assert res[-2]["verifies"]
    for r, out in enumerate(res):
        assert out["mesh"] == last["single"], (name, "W = 4", r)
        assert out["half"] == last["single"], (name, "W = 2", r)
    if os.path.exists(golden_path):
        assert last["single"] == read_golden(golden_path)["proof"]
    return last["single"]


def test_spartan_chain_on_meshes_equals_single_device_and_jax():
    """SpartanSNARK on ChainCircuit at W = 4 and on both halves at W = 2."""
    assert len(_chain("spartan", CHAIN_OUT)) > 0


def test_neutronnova_chain_on_meshes_equals_single_device_and_jax():
    """NeutronNovaZkSNARK on two ChainSteps and the Core at W = 4 and 2."""
    assert len(_chain("neutronnova", NN_CHAIN_OUT)) > 0


def test_a_mesh_needs_a_power_of_two_and_shards_cyclically(monkeypatch):
    from spartan2_tpu_torch.parallel import mesh as mesh_mod

    def fake_group(rank, size):
        monkeypatch.setattr(mesh_mod.dist, "get_rank", lambda g: rank)
        monkeypatch.setattr(mesh_mod.dist, "get_world_size", lambda g: size)
        monkeypatch.setattr(mesh_mod.dist, "get_backend", lambda g: "gloo")
        return mesh_mod.Mesh(group=object(), device="cpu")

    with pytest.raises(ValueError, match="power-of-two"):
        fake_group(0, 3)
    t = torch.arange(8 * 8, dtype=torch.int32).reshape(8, 8)
    assert torch.equal(fake_group(1, 4).shard(t), t[[1, 5]])
    m = fake_group(3, 4)
    assert m.log_size == 2 and torch.equal(m.shard(t[None])[0], t[[3, 7]])
    with pytest.raises(ValueError):
        m.shard(t[:6])
    assert not mesh_mod.sharded(None, 1 << 10)
    assert not mesh_mod.sharded(fake_group(0, 1), 1 << 10)
    assert not mesh_mod.sharded(m, 4)
    assert mesh_mod.sharded(m, 8)
