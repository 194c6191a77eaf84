"""Sum-check provers, and kernel F (csrc/round_finish.cu): the finish of
a round on the card.

Device-transcript provers, the port of the JAX package's
sumcheck/prove.py (SumcheckProverCubic :231, SumcheckProverQuad :304,
SumcheckProverCubicEq :403, SpartanInnerRound0 :604, and the fused
whole sum-checks of its sumcheck/fused.py): a round is its sums (kernel
A, B or G, sumcheck/device.py) left on the device, and the round finish
(kernel F: the round polynomial, its absorb under b"p" and the squeeze
of b"c" on the DeviceTranscript's state, the new claim, r and 1 - r into
device memory).  Kernel A's round binds the previous round's r, read
there, in its own launch (the JAX steps' bind_first); a sum-check on A
ends with one bind, and G's and B's rounds are each followed by theirs
(bind_dev, inner0_bind_dev), which read r there too.  Every round is
enqueued on the current stream and nothing is pulled: the outputs are
stacked device tensors, coefficients (m, k, 8) and challenges (m, 2, 8)
holding [r_j, 1 - r_j], Montgomery.  The JAX package fused whole
sum-checks, or their small tail rounds, into one program to save
dispatches; here every round is enqueued alike, so one prover serves
every round count, with no separate tail or fused variant.

The functions on (8,) Montgomery tensors below (from_evals3_dev,
from_evals4_dev, unipoly_eval_dev, absorb_unipoly, gruen_finish) are
kernel F's plain version, written with field/ops.py and the host Keccak.

Host-challenge drivers (``prove_cubic_eq``, ``prove_quad``): each round
pulls its sums, the host builds the round polynomial and squeezes the
host transcript (labels b"p" / b"c", as sumcheck.rs).  The ZK and
NeutronNova provers drive kernel A the same way through
sumcheck/zk_device.py with challenges from their verifier circuits; the
tests and chip_smoke.py hold the device-transcript provers against them.
"""

from __future__ import annotations

import functools

import torch

from ..field import ops
from ..field.constants import FieldSpec
from ..field.limbs import to_device
from ..polys.univariate import UniPoly
from ..transcript.device import DeviceTranscript
from ..transcript.transcript import Transcript
from ..utils.cuda import CudaKernel, I, P, check_cuda, fe_words, field_words
from .device import (CUBIC, QUAD, bind_dev, cubiceq_evals, eq_factors, eq_table, eq_tables,
                     inner0_bind_dev, inner0_sums, new_ticket, round_sums)
from .verify import SumcheckProof
from .zk_device import prove_zk_cubic, prove_zk_quad

ROUND_FINISH = CudaKernel("round_finish", {
    "sp2_round_finish": [I, I, I, I, I, P, P, P, P, P, P, P],
})

GRUEN, CUBIC_EVALS, QUAD_EVALS, INNER0 = 0, 1, 2, 3
_NSUMS = {GRUEN: 3, CUBIC_EVALS: 3, QUAD_EVALS: 2, INNER0: 3}
_NCOEFFS = {GRUEN: 4, CUBIC_EVALS: 4, QUAD_EVALS: 3, INNER0: 3}


# ---------------------------------------------------------------------------
# round algebra on (8,) Montgomery tensors: kernel F's plain version
# ---------------------------------------------------------------------------


def _mul(a, b, spec):
    return ops.mont_mul(a, b, spec)


def _dbl(a, spec):
    return ops.add(a, a, spec)


def _mconst(v: int, spec: FieldSpec, like: torch.Tensor) -> torch.Tensor:
    return ops.const(v, spec, device=like.device)


def from_evals3_dev(spec: FieldSpec, e0, e1, e2) -> torch.Tensor:
    """Evaluations at 0, 1, 2 -> (3, 8) coefficients (c, b, a)."""
    a = _mul(ops.add(ops.sub(e0, _dbl(e1, spec), spec), e2, spec),
             _mconst(spec.two_inv, spec, e0), spec)
    b = ops.sub(ops.sub(e1, e0, spec), a, spec)
    return torch.stack([e0, b, a])


def from_evals4_dev(spec: FieldSpec, e0, e1, e2, e3) -> torch.Tensor:
    """Evaluations at 0 .. 3 -> (4, 8) coefficients (d, c, b, a)."""
    e1_3 = ops.add(_dbl(e1, spec), e1, spec)
    e2_3 = ops.add(_dbl(e2, spec), e2, spec)
    delta3 = ops.sub(ops.add(ops.sub(e3, e2_3, spec), e1_3, spec), e0, spec)
    a = _mul(delta3, _mconst(pow(6, -1, spec.modulus), spec, e0), spec)
    delta2 = ops.add(ops.sub(e2, _dbl(e1, spec), spec), e0, spec)
    b = ops.sub(_mul(delta2, _mconst(spec.two_inv, spec, e0), spec),
                ops.add(_dbl(a, spec), a, spec), spec)
    c = ops.sub(ops.sub(ops.sub(e1, e0, spec), b, spec), a, spec)
    return torch.stack([e0, c, b, a])


def unipoly_eval_dev(spec: FieldSpec, coeffs: torch.Tensor, r: torch.Tensor):
    """Horner evaluation of (k, 8) coefficients at the (8,) point r."""
    acc = coeffs[-1]
    for c in coeffs.flip(0)[1:]:
        acc = ops.add(_mul(acc, r, spec), c, spec)
    return acc


def absorb_unipoly(td: DeviceTranscript, coeffs: torch.Tensor) -> None:
    """Absorb under b"p" the compressed coefficients [c0, c2, c3 ...], each
    32-byte canonical little-endian (univariate.rs:182-190)."""
    comp = torch.cat([coeffs[:1], coeffs[2:]])
    td.absorb_bytes(b"p", ops.to_bytes(comp, td.spec))


def gruen_finish(spec: FieldSpec, zero_check: bool, fallback: bool,
                 consts: torch.Tensor, t0_raw, tinf_raw, tm1_raw, P, claim,
                 td: DeviceTranscript):
    """One Gruen round's algebra from its raw sums: the coefficients, the
    squeeze of r on ``td``, the new claim and eq prefix -> (coeffs, r,
    new_claim, P_n).  ``consts``: (4, 8) [1 - tau, 2 tau - 1, 2 - 3 tau,
    1/tau (0 when tau = 0)]."""
    eq_0, eq_slope, eq_m1, inv_tau = consts
    zero = torch.zeros_like(claim)
    Tinf = _mul(tinf_raw, P, spec)
    c3 = _mul(eq_slope, Tinf, spec)
    if zero_check:
        T0 = c0 = e1 = zero
    else:
        T0 = _mul(t0_raw, P, spec)
        c0 = _mul(eq_0, T0, spec)
        e1 = ops.sub(claim, c0, spec)
    if fallback:  # tau = 0: t(-1) from its own sum
        Tm1 = _mul(tm1_raw, P, spec)
    else:
        Tm1 = ops.sub(ops.add(_dbl(Tinf, spec), _dbl(T0, spec), spec),
                      _mul(e1, inv_tau, spec), spec)
    s_m1 = _mul(eq_m1, Tm1, spec)
    half = _mconst(spec.two_inv, spec, claim)
    c1 = ops.sub(_mul(ops.sub(e1, s_m1, spec), half, spec), c3, spec)
    c2 = ops.sub(_mul(ops.add(e1, s_m1, spec), half, spec), c0, spec)
    coeffs = torch.stack([c0, c1, c2, c3])
    absorb_unipoly(td, coeffs)
    r = td.squeeze_mont(b"c")
    P_n = _mul(P, ops.add(eq_0, _mul(eq_slope, r, spec), spec), spec)
    return coeffs, r, unipoly_eval_dev(spec, coeffs, r), P_n


def _quad_coeffs(spec: FieldSpec, claim, t0, tinf) -> torch.Tensor:
    """BDDT: e2 = 2 claim - 3 t0 + 2 tinf."""
    e2 = ops.add(ops.sub(_dbl(claim, spec), ops.add(_dbl(t0, spec), t0, spec), spec),
                 _dbl(tinf, spec), spec)
    return from_evals3_dev(spec, t0, ops.sub(claim, t0, spec), e2)


def round_finish_plain(mode: int, partial, ctx, coeffs_out, r_out, round_: int,
                       spec: FieldSpec, consts=None, zero_check=False,
                       fallback=False) -> None:
    """Plain version of ``round_finish`` (in place into ctx and the slots)."""
    sums = [ops.sum_all(partial[:, t], spec) for t in range(_NSUMS[mode])]
    claim, P = ctx[0], ctx[1]
    td = DeviceTranscript(spec, state=ctx[2:].reshape(-1).view(torch.uint8).clone(),
                          round=round_)
    if mode == GRUEN:
        coeffs, r, new_claim, ctx[1] = gruen_finish(spec, zero_check, fallback, consts,
                                                    *sums, P, claim, td)
    else:
        if mode == CUBIC_EVALS:
            coeffs = from_evals4_dev(spec, sums[0], ops.sub(claim, sums[0], spec),
                                     sums[1], sums[2])
        elif mode == QUAD_EVALS:
            coeffs = _quad_coeffs(spec, claim, sums[0], sums[1])
        else:  # INNER0: t_inf = eval0 - corr_low + corr_cross
            tinf = ops.add(ops.sub(sums[0], sums[1], spec), sums[2], spec)
            coeffs = _quad_coeffs(spec, claim, sums[0], tinf)
        absorb_unipoly(td, coeffs)
        r = td.squeeze_mont(b"c")
        new_claim = unipoly_eval_dev(spec, coeffs, r)
    ctx[0] = new_claim
    ctx[2:] = td.state.view(torch.int32).reshape(2, 8)
    coeffs_out.copy_(coeffs)
    r_out[0] = r
    r_out[1] = ops.sub(_mconst(1, spec, r), r, spec)


def round_finish(mode: int, partial: torch.Tensor, ctx: torch.Tensor,
                 coeffs_out: torch.Tensor, r_out: torch.Tensor, round_: int,
                 spec: FieldSpec, consts=None, zero_check: bool = False,
                 fallback: bool = False) -> None:
    """Kernel F: finish one round from its sums, (rows, sums, 8) added up
    (kernel A's, B's or G's one row, or the ranks' gathered rows).
    ``ctx`` (4, 8): the running claim, eq prefix P and the 64-byte
    transcript state, updated in place; the round's coefficients go to
    ``coeffs_out`` (k, 8) and [r, 1 - r] to ``r_out`` (2, 8), Montgomery;
    ``round_`` is the transcript's round counter.  Modes: GRUEN (with
    ``consts`` (4, 8), zero_check, fallback), CUBIC_EVALS (sums at 0, 2,
    3), QUAD_EVALS (t0, tinf), INNER0 (kernel B's three sums)."""
    k = _NCOEFFS[mode]
    if partial.dim() != 3 or partial.shape[1:] != (_NSUMS[mode], 8):
        raise ValueError("round_finish: the sums must be (rows, sums, 8)")
    if ctx.shape != (4, 8) or coeffs_out.shape != (k, 8) or r_out.shape != (2, 8):
        raise ValueError("round_finish: ctx (4, 8), coeffs (k, 8), r (2, 8)")
    if mode == GRUEN and (consts is None or consts.shape != (4, 8)):
        raise ValueError("round_finish: a Gruen round needs its (4, 8) constants")
    if not 0 <= round_ < 0xFFFF:
        raise OverflowError("transcript round counter overflow")
    if partial.device.type == "cpu":
        round_finish_plain(mode, partial, ctx, coeffs_out, r_out, round_, spec, consts,
                           zero_check, fallback)
        return
    check_cuda(partial, ctx, coeffs_out, r_out, *([] if consts is None else [consts]))
    ROUND_FINISH.call("sp2_round_finish", mode, partial.shape[0], int(zero_check),
                      int(fallback), round_, partial.data_ptr(), ctx.data_ptr(),
                      None if consts is None else consts.data_ptr(),
                      coeffs_out.data_ptr(), r_out.data_ptr(), _inv_words(spec),
                      field_words(spec))


@functools.lru_cache(maxsize=None)
def _inv_words(spec: FieldSpec) -> bytes:
    """1/2 and 1/6 in Montgomery form, 16 words (kernel F's constants)."""
    return (fe_words(spec.to_mont(spec.two_inv))
            + fe_words(spec.to_mont(pow(6, -1, spec.modulus))))


# ---------------------------------------------------------------------------
# enqueued rounds
# ---------------------------------------------------------------------------


def one_dev(spec: FieldSpec, device) -> torch.Tensor:
    """Montgomery one, (8,), uploaded without a host synchronization."""
    return to_device([1], spec, device, mont=True, non_blocking=True)[0]


def _open(td: DeviceTranscript, claim: torch.Tensor, P: torch.Tensor, m: int, k: int):
    """-> (ctx, coeffs (m, k, 8), challenges (m, 2, 8)) on the device."""
    if td.parts:
        raise ValueError("a sum-check starts on an empty transcript buffer")
    dev = claim.device
    ctx = torch.cat([claim.reshape(1, 8), P.reshape(1, 8),
                     td.state.view(torch.int32).reshape(2, 8)])
    return (ctx, torch.empty(m, k, 8, dtype=torch.int32, device=dev),
            torch.empty(m, 2, 8, dtype=torch.int32, device=dev))


def _close(td: DeviceTranscript, ctx: torch.Tensor, m: int) -> torch.Tensor:
    """Hand the state back to ``td``, advance its round by m -> the claim."""
    td.state = ctx[2:].reshape(-1).view(torch.uint8)
    td.round += m
    return ctx[0]


def _rounds_on_a(spec: FieldSpec, mode: int, ctx, coeffs, rs, round0: int, vecs: list,
                 n: int, j0: int, j1: int, gather=None, ticket=None) -> None:
    """Rounds j0 .. j1 - 1 of kernel A's CUBIC (F's CUBIC_EVALS) or QUAD
    (QUAD_EVALS) mode over the first n rows of ``vecs``: each round after
    the first binds the one before it in its own launch, reading r from
    that round's slot, and one bind follows the last round; ``gather``
    joins a round's sums across ranks; ``ticket`` (``new_ticket``, made
    here if None) serves every round."""
    fmode = CUBIC_EVALS if mode == CUBIC else QUAD_EVALS
    if ticket is None:
        ticket = new_ticket(vecs[0].device)
    for j in range(j0, j1):
        if j > j0:
            n //= 2
        sums = round_sums(mode, n, vecs, spec, rs[j - 1] if j > j0 else None, ticket)
        round_finish(fmode, sums if gather is None else gather(sums), ctx, coeffs[j], rs[j],
                     round0 + j, spec)
    if j1 > j0:
        bind_dev(vecs, n, rs[j1 - 1], spec)


class SumcheckProverCubic:
    """sc_cubic_step's prover: claim = sum eq (A B - C) with the eq table
    materialized and bound as a fourth polynomial (kernel A CUBIC: sums
    at 0, 2, 3, the bind folded in; F from_evals4)."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec

    def prove(self, td: DeviceTranscript, eq, A, B, C, claim):
        """All rounds over (n, 8) eq, A, B, C (bound in place)
        -> (coeffs (m, 4, 8), challenges (m, 2, 8), finals, claim)."""
        n = eq.shape[0]
        m = n.bit_length() - 1
        ctx, coeffs, rs = _open(td, claim, one_dev(self.spec, eq.device), m, 4)
        self.rounds(ctx, coeffs, rs, td.round, [eq, A, B, C], n, 0, m)
        return coeffs, rs, (A[0], B[0], C[0]), _close(td, ctx, m)

    def rounds(self, ctx, coeffs, rs, round0: int, vecs: list, n: int, j0: int, j1: int,
               gather=None) -> None:
        """Rounds j0 .. j1 - 1 over the first n rows of ``vecs`` (bound in
        place); ``gather`` joins a round's sums across ranks."""
        _rounds_on_a(self.spec, CUBIC, ctx, coeffs, rs, round0, vecs, n, j0, j1, gather)


class SumcheckProverQuad:
    """prove_quad with the BDDT two-sum rounds (sumcheck.rs:190-247)."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec

    def prove(self, td: DeviceTranscript, A, B, claim, num_rounds: int, ticket=None):
        """claim = sum_x A(x) B(x) over the first 2^num_rounds rows (bound
        in place), every round one launch of kernel A (its two sums, the
        previous round's bind folded in) and F, then one bind
        -> (coeffs (m, 3, 8), challenges (m, 2, 8), (A, B) finals, claim)."""
        ctx, coeffs, rs = _open(td, claim, one_dev(self.spec, A.device), num_rounds, 3)
        self.rounds(ctx, coeffs, rs, td.round, [A, B], 1 << num_rounds, 0, num_rounds,
                    ticket=ticket)
        return coeffs, rs, (A[0], B[0]), _close(td, ctx, num_rounds)

    def rounds(self, ctx, coeffs, rs, round0: int, vecs: list, n: int, j0: int, j1: int,
               gather=None, ticket=None) -> None:
        """Rounds j0 .. j1 - 1 over the first n rows of ``vecs`` (bound in
        place); ``gather`` joins a round's sums across ranks."""
        _rounds_on_a(self.spec, QUAD, ctx, coeffs, rs, round0, vecs, n, j0, j1, gather,
                     ticket)


def _upload_with_eq_tables(spec: FieldSpec, head: list[int], splits: list, device):
    """One asynchronous upload of ``head`` and the eq factors [r, 1 - r]
    of each list in ``splits`` -> (head (len, 8), the eq tables, built on
    the device by kernel 2 in one launch), Montgomery."""
    p = spec.modulus
    fac = [[t % p for t in r] + [(1 - t) % p for t in r] for r in splits]
    flat = to_device(head + [v for f in fac for v in f], spec, device, mont=True,
                     non_blocking=True)
    tables = eq_tables(flat[len(head) :], [len(r) for r in splits], spec) if splits else []
    return flat[: len(head)], tables


class SumcheckProverCubicEq:
    """Gruen/BDDT eq-split cubic sum-check (sumcheck.rs:920-1428), the
    outer sum-check: no 2^m eq table.  Round j weighs its pairs with eq
    tables of the remaining taus, built on the card: EL_j = eq(taus[j+1:fh])
    times ER = eq(taus[fh:]) while j < fh - 1 (kernel G's two-level grid),
    then T_j = eq(taus[j+1:]).  t(0) and t(inf) come from kernel G, t(1)
    from the claim and 1/tau_j, and t(-1) from a third sum where
    tau_j = 0.  Given ``eff``, the inputs are zero at indices >= eff and
    round 0 reads the upper half only below it, binding the zero tail by
    1 - r0 (the JAX package's peeled round 0, fused.py:307-455; reference
    hi_eff, multilinear.rs:36-43)."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec

    def prove(self, td: DeviceTranscript, A, B, C, claim, taus: list[int],
              zero_check: bool = False, eff: int | None = None):
        """All m = len(taus) rounds over (2^m, 8) A, B, C (bound in place)
        -> (coeffs (m, 4, 8), challenges (m, 2, 8), finals, claim)."""
        m = len(taus)
        n = 1 << m
        if A.shape[0] < n:
            raise ValueError("outer sum-check: needs 2^len(taus) rows")
        plan = self.plan(taus, zero_check, A.device)
        ctx, coeffs, rs = _open(td, claim, one_dev(self.spec, A.device), m, 4)
        self.rounds(plan, ctx, coeffs, rs, td.round, [A, B, C], n, 0, m,
                    self.upper_live(n, eff))
        return coeffs, rs, (A[0], B[0], C[0]), _close(td, ctx, m)

    @staticmethod
    def upper_live(n: int, eff: int | None) -> int:
        """Round 0's rows of the upper half below ``eff`` (all without it)."""
        return n // 2 if eff is None else min(n // 2, max(0, eff - n // 2))

    @staticmethod
    def table_keys(m: int) -> list:
        """Per round of m: the (lo, hi) tau ranges of its EL (or None) and
        of its ER / T_j."""
        fh = m // 2
        return [((j + 1, fh), (fh, m)) if j < fh - 1 else (None, (j + 1, m))
                for j in range(m)]

    def plan(self, taus: list[int], zero_check: bool, device) -> dict:
        """Every round's constants and eq tables, in one upload: the (m, 4,
        8) constants, the (EL, ER) tables and rlog of each round."""
        spec = self.spec
        p = spec.modulus
        m = len(taus)
        fh = m // 2
        consts = []
        for t in taus:  # kernel F's [1 - tau, 2 tau - 1, 2 - 3 tau, 1/tau or 0]
            t %= p
            consts += [(1 - t) % p, (2 * t - 1) % p, (2 - 3 * t) % p,
                       pow(t, -1, p) if t else 0]
        keys = self.table_keys(m)
        uniq = sorted({k for pair in keys for k in pair if k is not None})
        consts, tables = _upload_with_eq_tables(spec, consts, [taus[a:b] for a, b in uniq],
                                                device)
        table = dict(zip(uniq, tables))
        return {"consts": consts.reshape(m, 4, 8), "zero_check": zero_check,
                "fallback": [t % p == 0 for t in taus],
                "tables": [(None if el is None else table[el], table[er],
                            0 if el is None else m - fh) for el, er in keys]}

    def rounds(self, plan: dict, ctx, coeffs, rs, round0: int, vecs: list, n: int,
               j0: int, j1: int, hi_len: int, shard: int = 0, lw: int = 0,
               gather=None) -> None:
        """Rounds j0 .. j1 - 1 over the first n rows of ``vecs`` (bound in
        place), round 0 reading the upper half's first ``hi_len`` global
        rows.  On rank ``shard`` of 2^lw the rows are the global rows
        shard + 2^lw i (kernel G weighs them so), and ``gather`` joins a
        round's sums across the ranks."""
        spec = self.spec
        ticket = new_ticket(vecs[0].device)
        for j in range(j0, j1):
            half = n // 2
            # round 0's live upper rows of this rank: ceil((hi_len - shard) / 2^lw)
            live = min(half, max(0, -(-(hi_len - shard) >> lw))) if j == 0 else half
            zc, fb = plan["zero_check"] and j == 0, plan["fallback"][j]
            EL, ER, rlog = plan["tables"][j]
            sums = cubiceq_evals(*vecs, half, live, EL, ER, rlog, zc, fb, spec, shard, lw,
                                 ticket)
            round_finish(GRUEN, sums if gather is None else gather(sums), ctx, coeffs[j],
                         rs[j], round0 + j, spec, plan["consts"][j], zc, fb)
            if live == half:
                bind_dev(vecs, n, rs[j], spec)
            else:
                inner0_bind_dev(vecs, rs[j], half, live, spec)
            n = half


class SpartanInnerRound0:
    """Round 0 of Spartan's inner sum-check (spartan.rs:326-394) over
    abc and z at width num_cols = num_vars + num_extra, the nonzero
    prefix of the virtual 2 num_vars polynomials: kernel B's sums, F, and
    kernel B's bind into width num_vars."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec

    def run(self, td: DeviceTranscript, abc, z, claim, num_vars: int, num_extra: int,
            ticket=None):
        """-> (claim after round 0, challenge slot (2, 8), coeffs (3, 8));
        ``ticket`` (``new_ticket``) may serve the quad rounds after it too."""
        spec = self.spec
        ctx, coeffs, rs = _open(td, claim, one_dev(spec, abc.device), 1, 3)
        sums = inner0_sums(abc, z, num_vars, num_extra, spec, ticket)
        round_finish(INNER0, sums, ctx, coeffs[0], rs[0], td.round, spec)
        inner0_bind_dev([abc, z], rs[0], num_vars, num_extra, spec)
        return _close(td, ctx, 1), rs[0], coeffs[0]


# ---------------------------------------------------------------------------
# host-challenge drivers
# ---------------------------------------------------------------------------


def challenge(transcript: Transcript, poly: UniPoly) -> int:
    """Absorb a round polynomial, squeeze the round's challenge."""
    transcript.absorb_bytes(b"p", poly.to_transcript_bytes())
    return transcript.squeeze(b"c")


def _recording(transcript: Transcript, polys: list):
    """A challenge_fn that keeps each round's compressed polynomial."""

    def fn(round_index: int, unis) -> int:
        polys.append(unis[0].compress())
        return challenge(transcript, unis[0])

    return fn


def prove_cubic_eq(transcript: Transcript, taus: list[int], A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, spec: FieldSpec,
                   claim: int = 0):
    """claim = sum_x eq(tau, x) (A(x) B(x) - C(x)) over 2^len(taus) points
    (reference prove_cubic_with_three_inputs, sumcheck.rs:502-571).
    A, B, C are (n, 8) Montgomery tensors, bound in place.
    -> (proof, r_x, [A(r_x), B(r_x), C(r_x)])."""
    polys: list = []
    E = eq_table(eq_factors(taus, spec, A.device), spec)
    rs, finals, _ = prove_zk_cubic(spec, [claim], E, (A[None], B[None], C[None]),
                                   _recording(transcript, polys))
    return SumcheckProof(spec, polys), rs, list(finals[0])


def prove_quad(transcript: Transcript, claim: int, A: torch.Tensor,
               B: torch.Tensor, spec: FieldSpec):
    """claim = sum_x A(x) B(x), degree-2 rounds with the evaluation at 2
    derived from the claim (reference prove_quad, sumcheck.rs:190-247).
    A, B are (n, 8) Montgomery tensors, bound in place.
    -> (proof, r, [A(r), B(r)])."""
    polys: list = []
    rs, finals = prove_zk_quad(spec, [claim], (A[None], B[None]),
                               A.shape[0].bit_length() - 1,
                               _recording(transcript, polys))
    return SumcheckProof(spec, polys), rs, list(finals[0])
