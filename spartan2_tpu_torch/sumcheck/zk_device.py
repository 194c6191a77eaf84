"""Sum-check drivers on kernels A and B (csrc/sumcheck.cu).

The ZK provers route every round polynomial through the verifier
circuit's commit protocol (MultiRoundState.process_round) instead of a
plain transcript squeeze, so each round's challenge comes from a
``challenge_fn(round_index, unipolys) -> r`` on the host
(sumcheck.rs:575-917); the non-ZK provers (sumcheck/prove.py) pass one
that absorbs the polynomial and squeezes the transcript.  Per round, one
launch of kernel A binds the previous round's challenge in place and sums
every instance from the bound values (the JAX steps' bind_first), the
host pulls those few scalars, interpolates each instance's round
polynomial and asks for the challenge; one bind launch after the last
round folds its challenge.

Instances sit on a leading axis K (K = 1 for SpartanZkSNARK, K = 2 for
NeutronNova's step/core lockstep), as in the reference's
prove_*_batched_zk (sumcheck.rs:702-917) and the JAX package's
sumcheck/zk_device.py (DeviceZkSumcheckCubic, DeviceZkSumcheckQuad,
ZkInnerRound0), whose messages these equal.
"""

from __future__ import annotations

import torch

from ..field.constants import FieldSpec
from ..field.limbs import limbs_to_ints
from ..polys.univariate import UniPoly
from .device import (CUBIC, QUAD, bind, inner0_bind, inner0_evals, new_ticket,
                     round_sums_batched, round_sums_bind)


def prove_zk_cubic(spec: FieldSpec, claims: list[int], E: torch.Tensor,
                   polys: tuple, challenge_fn):
    """claim_k = sum_j E[j] (A_k[j] B_k[j] - C_k[j]) for each instance k.
    ``E``: (n, 8) Montgomery, shared; ``polys``: (A, B, C), each (K, n, 8)
    Montgomery, all bound in place.  Round polynomials come from
    from_evals_deg3([t0, claim - t0, t2, t3]).
    -> (rs, finals[k] = (A_k, B_k, C_k) at rs, E at rs)."""
    A, B, C = polys
    K, n = A.shape[0], A.shape[1]
    rs: list[int] = []
    zk_rounds(CUBIC, spec, claims, [E, A, B, C], n, n.bit_length() - 1, rs,
              challenge_fn)
    vals = limbs_to_ints(torch.stack([A[:, 0], B[:, 0], C[:, 0], E[:1].expand(K, 8)],
                                     1).reshape(-1, 8), spec, mont=True)
    finals = [tuple(vals[4 * k : 4 * k + 3]) for k in range(K)]
    return rs, finals, vals[3]


def prove_zk_quad(spec: FieldSpec, claims: list[int], polys: tuple,
                  num_rounds: int, challenge_fn, ticket=None):
    """claim_k = sum_j A_k[j] Z_k[j] over the first 2^num_rounds entries.
    ``polys``: (A, Z), each (K, rows, 8) Montgomery, bound in place.  Round
    polynomials come from from_evals_deg2([t0, claim - t0,
    2 claim - 3 t0 + 2 t_inf]).  -> (rs, finals[k] = (A_k, Z_k) at rs)."""
    A, Z = polys
    K = A.shape[0]
    rs: list[int] = []
    zk_rounds(QUAD, spec, claims, [A, Z], 1 << num_rounds, num_rounds, rs, challenge_fn,
              ticket=ticket)
    vals = limbs_to_ints(torch.stack([A[:, 0], Z[:, 0]], 1).reshape(-1, 8), spec,
                         mont=True)
    return rs, [tuple(vals[2 * k : 2 * k + 2]) for k in range(K)]


def zk_rounds(mode: int, spec: FieldSpec, claims: list[int], vecs: list, n: int,
              rounds: int, rs: list, challenge_fn, gather=None, ticket=None) -> list[int]:
    """``rounds`` ZK rounds of kernel A's CUBIC (vecs E, A, B, C) or QUAD
    (A, Z) mode over the first n rows of ``vecs`` (bound in place: each
    round after the first binds the one before it in its own launch, and
    one bind follows the last), the
    challenges appended to ``rs`` and asked of ``challenge_fn(len(rs),
    unipolys)`` -> the claims after them.  ``gather`` joins a round's
    (K, sums, 8) sums across ranks, (W K, sums, 8) in rank order;
    ``ticket`` (``new_ticket``, made here if None) serves every round."""
    p = spec.modulus
    es = [c % p for c in claims]
    K = len(es)
    ns = 3 if mode == CUBIC else 2
    if ticket is None:
        ticket = new_ticket(vecs[0].device)
    # the eq vector shared by K > 1 instances is bound out of place, into
    # the other of two buffers in turn
    E = vecs[0]
    spare = torch.empty_like(E[: n // 2]) if mode == CUBIC and K > 1 and rounds > 1 else None
    vecs = list(vecs)
    r = None
    for _ in range(rounds):
        if r is None:
            sums = round_sums_batched(mode, n, vecs, spec, ticket)
        elif spare is None:
            sums = round_sums_bind(mode, n, vecs, r, spec, ticket)
        else:
            sums = round_sums_bind(mode, n, vecs, r, spec, ticket, spare)
            vecs[0], spare = spare, vecs[0]
        vals = limbs_to_ints(sums if gather is None else gather(sums), spec, mont=True)
        per = [[sum(vals[k * ns + t :: K * ns]) % p for t in range(ns)] for k in range(K)]
        if mode == CUBIC:
            unis = [UniPoly.from_evals_deg3(spec, [t0, (e - t0) % p, t2, t3])
                    for (t0, t2, t3), e in zip(per, es)]
        else:
            unis = [UniPoly.from_evals_deg2(spec, [t0, (e - t0) % p,
                                                   (2 * e - 3 * t0 + 2 * t_inf) % p])
                    for (t0, t_inf), e in zip(per, es)]
        r = challenge_fn(len(rs), unis)
        rs.append(r)
        es = [u.evaluate(r) for u in unis]
        n //= 2
    if r is not None:
        bind(vecs, 2 * n, r, spec)
    if vecs[0] is not E:
        E[:n].copy_(vecs[0][:n])
    return es


def inner_round0(spec: FieldSpec, claims: list[int], abc: torch.Tensor,
                 z: torch.Tensor, num_vars: int, num_extra: int,
                 challenge_fn, ticket=None):
    """Round 0 of the inner sum-check on kernel B, structured: abc and z
    hold the nonzero prefix (width num_cols = num_vars + num_extra) of
    the virtual 2 num_vars polynomials ((K, rows, 8) or (rows, 8)).  The
    round polynomial from_evals_deg2([eval0, claim - eval0,
    2 claim - 3 eval0 + 2 t_inf]) goes to ``challenge_fn(unipolys)``; abc
    and z are bound in place to width num_vars; ``ticket`` (``new_ticket``)
    may serve the rounds after it too.
    -> (r0, unipolys, claims after round 0)."""
    p = spec.modulus
    unis = [UniPoly.from_evals_deg2(spec, [e0, (c - e0) % p,
                                           (2 * c - 3 * e0 + 2 * t_inf) % p])
            for (e0, t_inf), c in zip(inner0_evals(abc, z, num_vars, num_extra, spec, ticket),
                                      claims)]
    r0 = challenge_fn(unis)
    inner0_bind(abc, z, r0, num_vars, num_extra, spec)
    return r0, unis, [u.evaluate(r0) for u in unis]
