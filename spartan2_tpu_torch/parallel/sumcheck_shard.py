"""Sum-checks sharded across the ranks of a mesh (parallel/mesh.py).

The port of the JAX package's parallel/sumcheck_shard.py and
parallel/fused_shard.py.  Each prover is a drop-in for its single-device
counterpart and gives the same messages byte for byte.  Rank s holds the
rows i = s (mod W) of every vector, so each round is:

* the round's sums over the rank's rows, left on the card as partial
  sums (kernel G for the Gruen rounds, with the weight of each pair's
  global index; kernel A for the others);
* one all_gather of the partial sums (a few hundred bytes a rank);
* the round finish on every rank from the W gathered partials (kernel F
  sums any number of them), the same claim, challenge and transcript
  state everywhere; for the ZK provers the host sums the gathered
  evaluations and asks the verifier circuit for the challenge;
* a bind of the rank's own rows (kernel A's bind, or kernel B's for the
  peeled outer round 0).

After the rounds that leave each rank one row, one all_gather of those
rows brings the W values in global order, and the last log2 W rounds run
on every rank with the single-device prover.  A sum-check over fewer
than 2W rows runs unsharded.  At its end each sharded Gruen and quad
sum-check checks that the transcript state is equal on every rank, each
ZK one that the challenges are.

The JAX package sharded each round's halves in contiguous blocks and let
XLA move data between rounds; the cyclic layout here moves none.
"""

from __future__ import annotations

import torch

from ..ec.comb import comb_rows
from ..field.constants import FieldSpec
from ..sumcheck.device import CUBIC, QUAD
from ..sumcheck.prove import (SumcheckProverCubic, SumcheckProverCubicEq,
                              SumcheckProverQuad, _close, _open, one_dev)
from ..sumcheck.zk_device import prove_zk_cubic, prove_zk_quad, zk_rounds
from ..transcript.device import DeviceTranscript
from .mesh import Mesh, sharded


def _rows(mesh: Mesh, vecs: list) -> list:
    """The ranks' first rows of each (rows, 8) vector -> each vector's W
    rows in global order, (W, 8)."""
    g = mesh.all_gather(torch.stack([v[0] for v in vecs]))  # (W k, 8)
    return list(g.view(mesh.size, len(vecs), 8).transpose(0, 1).contiguous())


def _rows_k(mesh: Mesh, vecs: list) -> list:
    """``_rows`` of (K, rows, 8) vectors -> each (K, W, 8)."""
    K = vecs[0].shape[0]
    g = mesh.all_gather(torch.stack([v[:, 0] for v in vecs]))  # (W k, K, 8)
    return list(g.view(mesh.size, len(vecs), K, 8).permute(1, 2, 0, 3).contiguous())


def _same_state(mesh: Mesh, ctx: torch.Tensor) -> None:
    mesh.same_on_all_ranks(ctx[2:], "the transcript state after a sharded sum-check")


class ShardedSumcheckCubicEq:
    """The outer Gruen/BDDT sum-check sharded (JAX ShardedSumcheckCubicEq,
    :164-325, and FusedShardedCubicEq, fused_shard.py:44-248): a drop-in
    for sumcheck/prove.py's SumcheckProverCubicEq, peeled round 0 (eff)
    and tau = 0 included.  The eq tables EL and ER are small and built on
    every rank; kernel G weighs local pair i by global pair s + W i."""

    def __init__(self, spec: FieldSpec, mesh: Mesh):
        self.spec = spec
        self.mesh = mesh

    def prove(self, td: DeviceTranscript, A, B, C, claim, taus: list[int],
              zero_check: bool = False, eff: int | None = None):
        single = SumcheckProverCubicEq(self.spec)
        m, mesh = len(taus), self.mesh
        n = 1 << m
        if not sharded(mesh, n):
            return single.prove(td, A, B, C, claim, taus, zero_check, eff)
        if A.shape[0] < n:
            raise ValueError("outer sum-check: needs 2^len(taus) rows")
        lw = mesh.log_size
        plan = single.plan(taus, zero_check, A.device)
        ctx, coeffs, rs = _open(td, claim, one_dev(self.spec, A.device), m, 4)
        hi_len = single.upper_live(n, eff)
        loc = [mesh.shard(v[:n]) for v in (A, B, C)]
        single.rounds(plan, ctx, coeffs, rs, td.round, loc, n >> lw, 0, m - lw, hi_len,
                      mesh.rank, lw, mesh.all_gather)
        full = _rows(mesh, loc)
        single.rounds(plan, ctx, coeffs, rs, td.round, full, mesh.size, m - lw, m, hi_len)
        _same_state(mesh, ctx)
        return coeffs, rs, tuple(v[0] for v in full), _close(td, ctx, m)


class ShardedSumcheckQuad:
    """The inner quad rounds sharded (JAX ShardedSumcheckQuad, :328-408):
    kernel A QUAD's sums gathered, F's QUAD_EVALS mode; a drop-in for
    SumcheckProverQuad."""

    def __init__(self, spec: FieldSpec, mesh: Mesh):
        self.spec = spec
        self.mesh = mesh

    def prove(self, td: DeviceTranscript, A, B, claim, num_rounds: int, ticket=None):
        single = SumcheckProverQuad(self.spec)
        mesh, n = self.mesh, 1 << num_rounds
        if not sharded(mesh, n):
            return single.prove(td, A, B, claim, num_rounds, ticket)
        lw = mesh.log_size
        ctx, coeffs, rs = _open(td, claim, one_dev(self.spec, A.device), num_rounds, 3)
        loc = [mesh.shard(v[:n]) for v in (A, B)]
        single.rounds(ctx, coeffs, rs, td.round, loc, n >> lw, 0, num_rounds - lw,
                      mesh.all_gather, ticket)
        full = _rows(mesh, loc)
        single.rounds(ctx, coeffs, rs, td.round, full, mesh.size, num_rounds - lw,
                      num_rounds, ticket=ticket)
        _same_state(mesh, ctx)
        return coeffs, rs, tuple(v[0] for v in full), _close(td, ctx, num_rounds)


class ShardedSumcheckCubic:
    """The explicit-eq cubic rounds sharded (JAX ShardedSumcheckCubic,
    :40-162): eq sharded like A, B and C, kernel A CUBIC's sums gathered,
    F's CUBIC_EVALS mode; a drop-in for SumcheckProverCubic."""

    def __init__(self, spec: FieldSpec, mesh: Mesh):
        self.spec = spec
        self.mesh = mesh

    def prove(self, td: DeviceTranscript, eq, A, B, C, claim):
        single = SumcheckProverCubic(self.spec)
        mesh, n = self.mesh, eq.shape[0]
        if not sharded(mesh, n):
            return single.prove(td, eq, A, B, C, claim)
        m, lw = n.bit_length() - 1, mesh.log_size
        ctx, coeffs, rs = _open(td, claim, one_dev(self.spec, eq.device), m, 4)
        loc = [mesh.shard(v[:n]) for v in (eq, A, B, C)]
        single.rounds(ctx, coeffs, rs, td.round, loc, n >> lw, 0, m - lw, mesh.all_gather)
        full = _rows(mesh, loc)
        single.rounds(ctx, coeffs, rs, td.round, full, mesh.size, m - lw, m)
        _same_state(mesh, ctx)
        return coeffs, rs, tuple(v[0] for v in full[1:]), _close(td, ctx, m)


def _same_challenges(mesh: Mesh, rs: list[int]) -> None:
    raw = b"".join(r.to_bytes(32, "little") for r in rs)
    mesh.same_on_all_ranks(torch.frombuffer(bytearray(raw), dtype=torch.uint8)
                           .to(mesh.device), "the challenges of a sharded ZK sum-check")


class ShardedZkSumcheckCubic:
    """The ZK cubic rounds over K instances sharded (JAX
    ShardedZkSumcheckCubic, :410-533): kernel A CUBIC's (K, 3) sums
    gathered and added on the host, the verifier circuit's challenge in
    between, the bind local; a drop-in for zk_device.prove_zk_cubic."""

    def __init__(self, spec: FieldSpec, mesh: Mesh):
        self.spec = spec
        self.mesh = mesh

    def prove(self, claims: list[int], E, polys: tuple, challenge_fn):
        spec, mesh = self.spec, self.mesh
        n = polys[0].shape[1]
        if not sharded(mesh, n):
            return prove_zk_cubic(spec, claims, E, polys, challenge_fn)
        lw = mesh.log_size
        loc = [mesh.shard(E[:n])] + [mesh.shard(v[:, :n]) for v in polys]
        rs: list[int] = []
        es = zk_rounds(CUBIC, spec, claims, loc, n >> lw, n.bit_length() - 1 - lw, rs,
                       challenge_fn, mesh.all_gather)
        E_t = _rows(mesh, loc[:1])[0]
        polys_t = _rows_k(mesh, loc[1:])
        done = len(rs)
        rs_tail, finals, e_final = prove_zk_cubic(
            spec, es, E_t, tuple(polys_t), lambda i, unis: challenge_fn(done + i, unis))
        _same_challenges(mesh, rs + rs_tail)
        return rs + rs_tail, finals, e_final


class ShardedZkSumcheckQuad:
    """The ZK quad rounds over K instances sharded (JAX
    ShardedZkSumcheckQuad, :535-627); a drop-in for zk_device.prove_zk_quad."""

    def __init__(self, spec: FieldSpec, mesh: Mesh):
        self.spec = spec
        self.mesh = mesh

    def prove(self, claims: list[int], polys: tuple, num_rounds: int, challenge_fn,
              ticket=None):
        spec, mesh, n = self.spec, self.mesh, 1 << num_rounds
        if not sharded(mesh, n):
            return prove_zk_quad(spec, claims, polys, num_rounds, challenge_fn, ticket)
        lw = mesh.log_size
        loc = [mesh.shard(v[:, :n]) for v in polys]
        rs: list[int] = []
        es = zk_rounds(QUAD, spec, claims, loc, n >> lw, num_rounds - lw, rs, challenge_fn,
                       mesh.all_gather, ticket)
        done = len(rs)
        rs_tail, finals = prove_zk_quad(spec, es, tuple(_rows_k(mesh, loc)), lw,
                                        lambda i, unis: challenge_fn(done + i, unis), ticket)
        _same_challenges(mesh, rs + rs_tail)
        return rs + rs_tail, finals


def commit_rows_sharded(mesh: Mesh, comb, scalars: torch.Tensor) -> torch.Tensor:
    """The comb rows-MSM (ec/comb.py comb_rows) with its rows split across
    the ranks (JAX :629-661): rank s takes the s-th block of the rows,
    padded with zero scalars to a multiple of W (a zero row is the
    identity), and one all_gather returns every row's Jacobian sum.
    ``scalars``: (R, C, 8) canonical, replicated -> (R, 3, 8)."""
    R = scalars.shape[0]
    per = -(-R // mesh.size)
    pad = per * mesh.size - R
    if pad:
        scalars = torch.cat([scalars, scalars.new_zeros(pad, *scalars.shape[1:])])
    mine = scalars[mesh.rank * per : (mesh.rank + 1) * per].contiguous()
    return mesh.all_gather(comb_rows(mine, comb.table, comb.curve))[:R]
