"""The ZK wrapper's verifier circuit: R1CS gadgets encoding Spartan's
algebraic checks.

Reference: src/zk.rs; the JAX package's snark/zk_circuits.py
(SpartanVerifierCircuit, NeutronNovaVerifierCircuit and their gadgets).  The SpartanVerifierCircuit constrains the
non-ZK Spartan verifier trace across outer rounds + outer-final + inner
rounds + inner-final + a dedicated eval_W commit round; Fiat-Shamir
challenges are NOT encoded: they come from the multi-round commit
protocol (zk.rs:12-13), allocated as public inputs per round.
"""

from __future__ import annotations

from typing import Optional

from ..field.constants import FieldSpec
from ..frontend.constraint_system import ONE, ConstraintSystem, Num, lc


def _val(x: Optional[int]) -> int:
    return 0 if x is None else x


def eval_poly_horner(cs: ConstraintSystem, coeffs: list[Num], x: Num) -> Num:
    """(zk.rs:19-45)."""
    p = cs.field.modulus
    acc = coeffs[-1]
    for c_i in reversed(coeffs[:-1]):
        val = None
        if not cs.shape_mode:
            val = (_val(acc.value) * _val(x.value) + _val(c_i.value)) % p
        new_acc = Num.alloc(cs, val)
        cs.enforce(lc((1, acc.var)), lc((1, x.var)),
                   lc((1, new_acc.var), (-1, c_i.var)))
        acc = new_acc
    return acc


def alloc_zero(cs: ConstraintSystem) -> Num:
    z = Num.alloc(cs, None if cs.shape_mode else 0)
    cs.enforce(lc((1, z.var)), lc((1, ONE)), lc())
    return z


def alloc_coeffs(cs: ConstraintSystem, coeffs: list[int]) -> list[Num]:
    return [Num.alloc(cs, None if cs.shape_mode else c) for c in coeffs]


def enforce_sc_claim(cs: ConstraintSystem, poly: list[Num], claim: Num) -> None:
    """poly(0) + poly(1) == claim, i.e. 2*c0 + c1 + ... + cn == claim
    (zk.rs:85-104)."""
    terms = [(1, p.var) for p in poly] + [(1, poly[0].var)]
    cs.enforce(lc(*terms), lc((1, ONE)), lc((1, claim.var)))


def enforce_outer_sc_final_check(cs: ConstraintSystem, claim_Az: Num,
                                 claim_Bz: Num, claim_Cz: Num, tau_at_rx: Num,
                                 prev_claim: Num) -> None:
    """prev_claim = tau_at_rx * (Az*Bz - Cz) (zk.rs:108-128)."""
    prod = claim_Az.mul(cs, claim_Bz)
    cs.enforce(lc((1, tau_at_rx.var)), lc((1, prod.var), (-1, claim_Cz.var)),
               lc((1, prev_claim.var)))


def compute_joint_claim(cs: ConstraintSystem, Az: Num, Bz: Num, Cz: Num,
                        r: Num, r_sq: Num) -> Num:
    """joint = Az + r*Bz + r^2*Cz (zk.rs:131-160)."""
    p = cs.field.modulus
    r_Bz = r.mul(cs, Bz)
    val = None
    if not cs.shape_mode:
        val = (_val(Az.value) + _val(r_Bz.value)
               + _val(r_sq.value) * _val(Cz.value)) % p
    joint = Num.alloc(cs, val)
    cs.enforce(lc((1, Cz.var)), lc((1, r_sq.var)),
               lc((1, joint.var), (-1, Az.var), (-1, r_Bz.var)))
    return joint


def enforce_inner_sc_final_check(cs: ConstraintSystem, r_y0: Num, eval_W: Num,
                                 eval_X: Num, prev_claim: Num) -> None:
    """eval_z = (1-r_y0)*eval_W + r_y0*eval_X; inputize quotient =
    prev_claim / eval_z (zk.rs:166-226)."""
    p = cs.field.modulus
    tw_val = None
    if not cs.shape_mode:
        tw_val = _val(eval_W.value) * (1 - _val(r_y0.value)) % p
    tmp_w = Num.alloc(cs, tw_val)
    cs.enforce(lc((1, eval_W.var)), lc((1, ONE), (-1, r_y0.var)),
               lc((1, tmp_w.var)))

    sz_val = None
    if not cs.shape_mode:
        sz_val = (_val(tmp_w.value) + _val(eval_X.value) * _val(r_y0.value)) % p
    sum_z = Num.alloc(cs, sz_val)
    cs.enforce(lc((1, eval_X.var)), lc((1, r_y0.var)),
               lc((1, sum_z.var), (-1, tmp_w.var)))

    q_val = None
    if not cs.shape_mode:
        sz = _val(sum_z.value)
        q_val = 0 if sz == 0 else _val(prev_claim.value) * pow(sz, -1, p) % p
    quotient_var = cs.alloc_input(q_val)
    cs.enforce(lc((1, quotient_var)), lc((1, sum_z.var)),
               lc((1, prev_claim.var)))


class SpartanVerifierCircuit:
    """Multi-round circuit over outer/inner sum-check rounds (zk.rs:230-469).

    Round layout: [0, nx) outer, nx outer-final, [nx+1, nx+1+ny) inner,
    nx+1+ny inner-final, nx+2+ny eval_W commit.  One challenge per round
    up to inner-final; the challenge passed to round i is the one squeezed
    after round i-1's commitment.
    """

    def __init__(self, field: FieldSpec, num_rounds_x: int, num_rounds_y: int,
                 mr_commitment_width: int):
        self.field = field
        self.outer_polys: list[list[int]] = [[0] * 4 for _ in range(num_rounds_x)]
        self.claim_Az = 0
        self.claim_Bz = 0
        self.claim_Cz = 0
        self.tau_at_rx = 0
        self.inner_polys: list[list[int]] = [[0] * 3 for _ in range(num_rounds_y)]
        self.eval_W = 0
        self.eval_X = 0
        self.mr_commitment_width = mr_commitment_width

    # -- round indices (zk.rs:258-278) --
    def num_outer_rounds(self) -> int:
        return len(self.outer_polys)

    def num_inner_rounds(self) -> int:
        return len(self.inner_polys)

    def idx_outer_final(self) -> int:
        return self.num_outer_rounds()

    def idx_inner_start(self) -> int:
        return self.idx_outer_final() + 1

    def idx_inner_final(self) -> int:
        return self.idx_inner_start() + self.num_inner_rounds()

    def idx_commit_w(self) -> int:
        return self.idx_inner_final() + 1

    # -- MultiRoundCircuitAPI --
    def num_challenges(self, round_index: int) -> int:
        if round_index < self.idx_inner_final():
            return 1
        if round_index in (self.idx_inner_final(), self.idx_commit_w()):
            return 0
        raise ValueError("bad round index")

    def num_rounds(self) -> int:
        return self.idx_commit_w() + 1

    def commitment_width(self) -> int:
        return self.mr_commitment_width

    def rounds(self, cs: ConstraintSystem, round_index: int,
               prior_round_vars: list[list[Num]],
               prev_challenges: list[list[Num]],
               challenges: Optional[list[int]]) -> tuple[list[Num], list[Num]]:
        chal0 = challenges[0] if challenges else None

        if round_index < self.idx_outer_final():
            poly = alloc_coeffs(cs, self.outer_polys[round_index])
            if round_index == 0:
                claim = alloc_zero(cs)
            else:
                r_x_var = cs.alloc_input(chal0 if not cs.shape_mode else None)
                r_x = Num(r_x_var, chal0)
                claim = eval_poly_horner(cs, prior_round_vars[round_index - 1], r_x)
            enforce_sc_claim(cs, poly, claim)
            return poly, []

        if round_index == self.idx_outer_final():
            r_var = cs.alloc_input(chal0 if not cs.shape_mode else None)
            r = Num(r_var, chal0)
            claim = eval_poly_horner(cs, prior_round_vars[round_index - 1], r)
            sm = cs.shape_mode
            claim_Az = Num.alloc(cs, None if sm else self.claim_Az)
            claim_Bz = Num.alloc(cs, None if sm else self.claim_Bz)
            claim_Cz = Num.alloc(cs, None if sm else self.claim_Cz)
            tau_at_rx = Num.alloc(cs, None if sm else self.tau_at_rx)
            enforce_outer_sc_final_check(cs, claim_Az, claim_Bz, claim_Cz,
                                         tau_at_rx, claim)
            return [claim_Az, claim_Bz, claim_Cz, tau_at_rx], []

        if self.idx_inner_start() <= round_index < self.idx_inner_final():
            idx = round_index - self.idx_inner_start()
            poly = alloc_coeffs(cs, self.inner_polys[idx])
            r_var = cs.alloc_input(chal0 if not cs.shape_mode else None)
            r = Num(r_var, chal0)
            if idx == 0:
                r_sq = r.square(cs)
                co = prior_round_vars[self.idx_outer_final()]
                claim = compute_joint_claim(cs, co[0], co[1], co[2], r, r_sq)
            else:
                claim = eval_poly_horner(cs, prior_round_vars[round_index - 1], r)
            enforce_sc_claim(cs, poly, claim)
            return poly, [r]

        if round_index == self.idx_inner_final():
            r_y_var = cs.alloc_input(chal0 if not cs.shape_mode else None)
            r_y = Num(r_y_var, chal0)
            claim = eval_poly_horner(cs, prior_round_vars[round_index - 1], r_y)
            sm = cs.shape_mode
            eval_W = Num.alloc(cs, None if sm else self.eval_W)
            tau_at_rx = prior_round_vars[self.idx_outer_final()][3]
            tau_at_rx.inputize(cs)
            eval_X_var = cs.alloc_input(None if sm else self.eval_X)
            eval_X = Num(eval_X_var, None if sm else self.eval_X)
            r_y0 = prev_challenges[self.idx_inner_start() + 1][0]
            enforce_inner_sc_final_check(cs, r_y0, eval_W, eval_X, claim)
            return [eval_W], []

        if round_index == self.idx_commit_w():
            sm = cs.shape_mode
            eval_W = Num.alloc(cs, None if sm else self.eval_W)
            prev = prior_round_vars[round_index - 1][0]
            cs.enforce(lc((1, eval_W.var)), lc((1, ONE)), lc((1, prev.var)))
            for _ in range(self.mr_commitment_width - 1):
                alloc_zero(cs)
            return [eval_W], []

        raise ValueError("bad round index")


class NeutronNovaVerifierCircuit:
    """Multi-round circuit for the NeutronNova verifier trace
    (zk.rs:472-943): NIFS cubic rounds + NIFS-final + batched step/core
    outer rounds + outer-final + batched inner rounds + inner-final +
    two eval_W commit rounds.  Public values (in order): tau_at_rx,
    eval_X_step, eval_X_core, eq_rho_at_rb, quotient_step, quotient_core.
    """

    def __init__(self, field: FieldSpec, num_rounds_b: int, num_rounds_x: int,
                 num_rounds_y: int, mr_commitment_width: int):
        self.field = field
        self.nifs_polys: list[list[int]] = [[0] * 4 for _ in range(num_rounds_b)]
        self.eq_rho_at_rb = 0
        self.t_out_step = 0
        self.outer_polys_step: list[list[int]] = [[0] * 4 for _ in range(num_rounds_x)]
        self.outer_polys_core: list[list[int]] = [[0] * 4 for _ in range(num_rounds_x)]
        self.claim_Az_step = self.claim_Bz_step = self.claim_Cz_step = 0
        self.claim_Az_core = self.claim_Bz_core = self.claim_Cz_core = 0
        self.tau_at_rx = 0
        self.inner_polys_step: list[list[int]] = [[0] * 3 for _ in range(num_rounds_y)]
        self.inner_polys_core: list[list[int]] = [[0] * 3 for _ in range(num_rounds_y)]
        self.eval_W_step = self.eval_W_core = 0
        self.eval_X_step = self.eval_X_core = 0
        self.mr_commitment_width = mr_commitment_width

    # -- round indices (zk.rs:539-578) --
    def num_nifs_rounds(self) -> int:
        return len(self.nifs_polys)

    def idx_nifs_final(self) -> int:
        return self.num_nifs_rounds()

    def idx_outer_start(self) -> int:
        return self.idx_nifs_final() + 1

    def idx_outer_final(self) -> int:
        return self.idx_outer_start() + len(self.outer_polys_step)

    def idx_inner_start(self) -> int:
        return self.idx_outer_final() + 1

    def idx_inner_final(self) -> int:
        return self.idx_inner_start() + len(self.inner_polys_step)

    def idx_commit_w_step(self) -> int:
        return self.idx_inner_final() + 1

    def idx_commit_w_core(self) -> int:
        return self.idx_commit_w_step() + 1

    def num_challenges(self, round_index: int) -> int:
        if round_index < self.num_nifs_rounds():
            return 1
        if round_index == self.idx_nifs_final():
            return 0
        if round_index < self.idx_inner_final():
            return 1
        if round_index in (self.idx_inner_final(), self.idx_commit_w_step(),
                           self.idx_commit_w_core()):
            return 0
        raise ValueError("bad round index")

    def num_rounds(self) -> int:
        return self.idx_commit_w_core() + 1

    def commitment_width(self) -> int:
        return self.mr_commitment_width

    def rounds(self, cs: ConstraintSystem, round_index: int,
               prior_round_vars: list[list[Num]],
               prev_challenges: list[list[Num]],
               challenges: Optional[list[int]]) -> tuple[list[Num], list[Num]]:
        chal0 = challenges[0] if challenges else None
        sm = cs.shape_mode

        def alloc_challenge_input() -> Num:
            var = cs.alloc_input(chal0 if not sm else None)
            return Num(var, chal0)

        if round_index < self.num_nifs_rounds():
            poly = alloc_coeffs(cs, self.nifs_polys[round_index])
            if round_index == 0:
                claim = alloc_zero(cs)
            else:
                r = alloc_challenge_input()
                claim = eval_poly_horner(cs, prior_round_vars[round_index - 1], r)
            enforce_sc_claim(cs, poly, claim)
            return poly, []

        if round_index == self.idx_nifs_final():
            r = alloc_challenge_input()
            claim = eval_poly_horner(cs, prior_round_vars[round_index - 1], r)
            t_out_step = Num.alloc(cs, None if sm else self.t_out_step)
            eq_rho_at_rb = Num.alloc(cs, None if sm else self.eq_rho_at_rb)
            cs.enforce(lc((1, eq_rho_at_rb.var)), lc((1, t_out_step.var)),
                       lc((1, claim.var)))
            return [eq_rho_at_rb, t_out_step], []

        if self.idx_outer_start() <= round_index < self.idx_outer_final():
            i = round_index - self.idx_outer_start()
            poly_step = alloc_coeffs(cs, self.outer_polys_step[i])
            poly_core = alloc_coeffs(cs, self.outer_polys_core[i])
            if i == 0:
                claim_step = prior_round_vars[round_index - 1][1]
                claim_core = alloc_zero(cs)
            else:
                r = alloc_challenge_input()
                claim_step = eval_poly_horner(
                    cs, prior_round_vars[round_index - 1][0:4], r)
                claim_core = eval_poly_horner(
                    cs, prior_round_vars[round_index - 1][4:8], r)
            enforce_sc_claim(cs, poly_step, claim_step)
            enforce_sc_claim(cs, poly_core, claim_core)
            return poly_step + poly_core, []

        if round_index == self.idx_outer_final():
            r = alloc_challenge_input()
            claim_step = eval_poly_horner(
                cs, prior_round_vars[round_index - 1][0:4], r)
            claim_core = eval_poly_horner(
                cs, prior_round_vars[round_index - 1][4:8], r)
            cAs = Num.alloc(cs, None if sm else self.claim_Az_step)
            cBs = Num.alloc(cs, None if sm else self.claim_Bz_step)
            cCs = Num.alloc(cs, None if sm else self.claim_Cz_step)
            cAc = Num.alloc(cs, None if sm else self.claim_Az_core)
            cBc = Num.alloc(cs, None if sm else self.claim_Bz_core)
            cCc = Num.alloc(cs, None if sm else self.claim_Cz_core)
            tau_at_rx = Num.alloc(cs, None if sm else self.tau_at_rx)
            enforce_outer_sc_final_check(cs, cAs, cBs, cCs, tau_at_rx, claim_step)
            enforce_outer_sc_final_check(cs, cAc, cBc, cCc, tau_at_rx, claim_core)
            return [cAs, cBs, cCs, cAc, cBc, cCc, tau_at_rx], []

        if self.idx_inner_start() <= round_index < self.idx_inner_final():
            idx = round_index - self.idx_inner_start()
            poly_step = alloc_coeffs(cs, self.inner_polys_step[idx])
            poly_core = alloc_coeffs(cs, self.inner_polys_core[idx])
            r = alloc_challenge_input()
            if idx == 0:
                r_sq = r.square(cs)
                co = prior_round_vars[self.idx_outer_final()]
                claim_step = compute_joint_claim(cs, co[0], co[1], co[2], r, r_sq)
                claim_core = compute_joint_claim(cs, co[3], co[4], co[5], r, r_sq)
            else:
                claim_step = eval_poly_horner(
                    cs, prior_round_vars[round_index - 1][0:3], r)
                claim_core = eval_poly_horner(
                    cs, prior_round_vars[round_index - 1][3:6], r)
            enforce_sc_claim(cs, poly_step, claim_step)
            enforce_sc_claim(cs, poly_core, claim_core)
            return poly_step + poly_core, [r]

        if round_index == self.idx_inner_final():
            r = alloc_challenge_input()
            claim_step = eval_poly_horner(
                cs, prior_round_vars[round_index - 1][0:3], r)
            claim_core = eval_poly_horner(
                cs, prior_round_vars[round_index - 1][3:6], r)
            tau_at_rx = prior_round_vars[self.idx_outer_final()][6]
            tau_at_rx.inputize(cs)
            eval_X_step_var = cs.alloc_input(None if sm else self.eval_X_step)
            eval_X_step = Num(eval_X_step_var, None if sm else self.eval_X_step)
            eval_X_core_var = cs.alloc_input(None if sm else self.eval_X_core)
            eval_X_core = Num(eval_X_core_var, None if sm else self.eval_X_core)
            eq_rho_at_rb = prior_round_vars[self.idx_nifs_final()][0]
            eq_rho_at_rb.inputize(cs)
            eval_W_step = Num.alloc(cs, None if sm else self.eval_W_step)
            eval_W_core = Num.alloc(cs, None if sm else self.eval_W_core)
            r_y0 = prev_challenges[self.idx_inner_start() + 1][0]
            enforce_inner_sc_final_check(cs, r_y0, eval_W_step, eval_X_step,
                                         claim_step)
            enforce_inner_sc_final_check(cs, r_y0, eval_W_core, eval_X_core,
                                         claim_core)
            return [eval_W_step, eval_W_core], []

        if round_index == self.idx_commit_w_step():
            eval_W = Num.alloc(cs, None if sm else self.eval_W_step)
            prev = prior_round_vars[round_index - 1][0]
            cs.enforce(lc((1, eval_W.var)), lc((1, ONE)), lc((1, prev.var)))
            for _ in range(self.mr_commitment_width - 1):
                alloc_zero(cs)
            return [], []

        if round_index == self.idx_commit_w_core():
            eval_W = Num.alloc(cs, None if sm else self.eval_W_core)
            prev = prior_round_vars[round_index - 2][1]
            cs.enforce(lc((1, eval_W.var)), lc((1, ONE)), lc((1, prev.var)))
            for _ in range(self.mr_commitment_width - 1):
                alloc_zero(cs)
            return [], []

        raise ValueError("bad round index")
