"""NeutronNova's NIFS rounds: kernels 3 and 4 (csrc/nifs.cu), their plain
versions, and the round driver.

Reference: src/neutronnova_zk.rs:511-1168 (prove_helper and the fold of
the instance axis), through the JAX package's NifsRoundsDevice
(spartan2_tpu/sumcheck/zk_device.py:323-525).  The (instance, constraint)
grid of Az, Bz, Cz lives on the card as three (I, n, 8) Montgomery
tensors.  Round t folds the previous challenge into the instance axis
(adjacent pairs (2i, 2i + 1)) and sums, over the pairs q that remain and
weighted by the suffix weight w_q,
    e0   = sum_k E_k (Ae Be - Ce),   quad = sum_k E_k (Ao - Ae)(Bo - Be);
the host turns (e0, quad) into the round polynomial and the challenge.
Round 0 runs on small integers (kernel 4) when the whole grid passed
the small-value gate, else on kernel 3 like the other rounds.

On CUDA tensors each wrapper launches its kernel or raises; on CPU
tensors it runs the plain version.
"""

from __future__ import annotations

import torch

from ..field import ops
from ..field.constants import FieldSpec
from ..field.limbs import limbs_to_ints, to_device
from ..field.small_value import small_round_plain, to_small_plain
from ..utils.cuda import SZ, CudaKernel, I, P, check_cuda, fe_words, field_words

NIFS = CudaKernel("nifs", {
    "sp2_nifs_round": [I, SZ, I, P, P, P, P, P, P, P, I, P, P],
    "sp2_nifs_fold": [I, SZ, P, P, P, P, P],
    "sp2_weighted_fold": [I, SZ, P, P, P, P],
    "sp2_nifs_to_small": [SZ, P, P, P, P, P, P],
    "sp2_nifs_small_round": [I, SZ, P, P, P, P, I, P, P],
})

_NT = 256
_MAX_CHUNKS = 512


def _chunks(n: int) -> int:
    return max(1, min(-(-n // _NT), _MAX_CHUNKS))


def _check_grid(A, B, C) -> None:
    check_cuda(A, B, C)
    if A.dim() != 3 or A.shape[-1] != 8 or A.shape != B.shape or A.shape != C.shape:
        raise ValueError("nifs: A, B, C must be (I, n, 8) of one shape")


def suffix_weight(spec: FieldSpec, t: int, ell_b: int, pair_idx: int,
                  rhos: list[int]) -> int:
    """prod_{s > t} eq(rho_s, bit_s(pair_idx)), pair bits LSB-first
    (neutronnova_zk.rs:77-87)."""
    p = spec.modulus
    w, k = 1, pair_idx
    for s in range(t + 1, ell_b):
        w = w * (rhos[s] if k & 1 else (1 - rhos[s]) % p) % p
        k >>= 1
    return w


# ---------------------------------------------------------------------------
# kernel 3: Montgomery rounds and folds
# ---------------------------------------------------------------------------


def _fold_plain(grids, r: int, spec: FieldSpec) -> None:
    rr = ops.const(r, spec, device=grids[0].device)
    for X in grids:
        even, odd = X[0::2], X[1::2]
        X[: X.shape[0] // 2] = ops.add(even, ops.mont_mul(rr, ops.sub(odd, even, spec),
                                                          spec), spec)


def nifs_round_plain(A, B, C, E, w, r: int, bind_first: bool,
                     spec: FieldSpec) -> torch.Tensor:
    """Plain version of ``nifs_round``: (2, 8) Montgomery [e0, quad]."""
    if bind_first:
        _fold_plain((A, B, C), r, spec)
    cur = A.shape[0] // 2 if bind_first else A.shape[0]
    Ae, Ao, Be, Bo, Ce = A[0:cur:2], A[1:cur:2], B[0:cur:2], B[1:cur:2], C[0:cur:2]
    e0 = ops.mont_mul(E, ops.sub(ops.mont_mul(Ae, Be, spec), Ce, spec), spec)
    quad = ops.mont_mul(E, ops.mont_mul(ops.sub(Ao, Ae, spec), ops.sub(Bo, Be, spec),
                                        spec), spec)
    out = []
    for g in (e0, quad):
        sums = torch.stack([ops.sum_all(x, spec) for x in g])  # (pairs, 8)
        out.append(ops.sum_all(ops.mont_mul(w, sums, spec), spec))
    return torch.stack(out)


def nifs_round(A, B, C, E, w, r: int, bind_first: bool, spec: FieldSpec) -> list[int]:
    """Kernel 3's round.  A, B, C: (I, n, 8) Montgomery grids; if
    ``bind_first``, instances (2i, 2i + 1) are first folded with the
    canonical challenge r into row i, in place (rows [0, I/2) then hold the
    grid).  Then over the pairs q of the grid: [e0, quad] =
    sum_q w_q [sum_k E_k (Ae Be - Ce), sum_k E_k (Ao - Ae)(Bo - Be)], E
    (n, 8) and w (pairs, 8) Montgomery; -> canonical ints."""
    if A.device.type == "cpu":
        return limbs_to_ints(nifs_round_plain(A, B, C, E, w, r, bind_first, spec),
                             spec, mont=True)
    _check_grid(A, B, C)
    check_cuda(E, w)
    Ig, n = A.shape[0], A.shape[1]
    pairs = (Ig // 2 if bind_first else Ig) // 2
    if E.shape != (n, 8) or w.shape != (pairs, 8) or pairs < 1:
        raise ValueError("nifs_round: E must be (n, 8) and w (pairs, 8)")
    nch = _chunks(n)
    partial = torch.empty(pairs * nch * 2, 8, dtype=torch.int32, device=A.device)
    out = torch.empty(2, 8, dtype=torch.int32, device=A.device)
    NIFS.call("sp2_nifs_round", Ig, n, int(bind_first), fe_words(spec.to_mont(r)),
              A.data_ptr(), B.data_ptr(), C.data_ptr(), E.data_ptr(), w.data_ptr(),
              partial.data_ptr(), nch, out.data_ptr(), field_words(spec))
    return limbs_to_ints(out, spec, mont=True)


def nifs_fold(A, B, C, r: int, spec: FieldSpec) -> None:
    """Kernel 3's fold alone: rows (2i, 2i + 1) -> row i with the canonical
    challenge r, in place (the final fold, I = 2 -> 1)."""
    if A.device.type == "cpu":
        _fold_plain((A, B, C), r, spec)
        return
    _check_grid(A, B, C)
    NIFS.call("sp2_nifs_fold", A.shape[0], A.shape[1], fe_words(spec.to_mont(r)),
              A.data_ptr(), B.data_ptr(), C.data_ptr(), field_words(spec))


def weighted_fold_plain(W: torch.Tensor, w: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Plain version of ``weighted_fold``."""
    acc = ops.mont_mul(w[0], W[0], spec)
    for i in range(1, W.shape[0]):
        acc = ops.add(acc, ops.mont_mul(w[i], W[i], spec), spec)
    return acc


def weighted_fold(W: torch.Tensor, w: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Kernel 3's weighted fold: (I, n, 8) Montgomery rows and (I, 8)
    Montgomery weights -> (n, 8) Montgomery sum_i w_i W_i."""
    if W.device.type == "cpu":
        return weighted_fold_plain(W, w, spec)
    check_cuda(W, w)
    if W.dim() != 3 or W.shape[-1] != 8 or w.shape != (W.shape[0], 8):
        raise ValueError("weighted_fold: W (I, n, 8) and w (I, 8)")
    out = torch.empty(W.shape[1], 8, dtype=torch.int32, device=W.device)
    NIFS.call("sp2_weighted_fold", W.shape[0], W.shape[1], w.data_ptr(), W.data_ptr(),
              out.data_ptr(), field_words(spec))
    return out


# ---------------------------------------------------------------------------
# kernel 4: small-value round 0
# ---------------------------------------------------------------------------


def to_small(A, B, C, spec: FieldSpec) -> tuple[torch.Tensor, bool]:
    """Kernel 4's conversion of the (I, n, 8) Montgomery grids -> ((3, I, n, 4)
    small entries, whether every entry passed the 2^72 gate)."""
    if A.device.type == "cpu":
        outs = [to_small_plain(X, spec) for X in (A, B, C)]
        return (torch.stack([s for s, _ in outs]),
                all(bool(ok.all()) for _, ok in outs))
    _check_grid(A, B, C)
    S = torch.empty(3, *A.shape[:2], 4, dtype=torch.int32, device=A.device)
    ok = torch.ones(1, dtype=torch.int32, device=A.device)
    NIFS.call("sp2_nifs_to_small", A.shape[0] * A.shape[1], A.data_ptr(), B.data_ptr(),
              C.data_ptr(), S.data_ptr(), ok.data_ptr(), field_words(spec))
    return S, bool(ok.item())


def small_round(S: torch.Tensor, E: torch.Tensor, w: torch.Tensor,
                spec: FieldSpec) -> list[int]:
    """Kernel 4's round 0 from the small grid S (3, I, n, 4) (of a grid
    that passed the gate): the same [e0, quad] as ``nifs_round`` without a
    fold, by exact integer products; -> canonical ints."""
    if S.device.type == "cpu":
        return limbs_to_ints(small_round_plain(S, E, w, spec), spec)
    check_cuda(S, E, w)
    Ig, n = S.shape[1], S.shape[2]
    pairs = Ig // 2
    if S.shape != (3, Ig, n, 4) or E.shape != (n, 8) or w.shape != (pairs, 8):
        raise ValueError("small_round: S (3, I, n, 4), E (n, 8), w (I/2, 8)")
    nch = _chunks(n)
    partial = torch.empty(pairs * nch * 2, 8, dtype=torch.int32, device=S.device)
    out = torch.empty(2, 8, dtype=torch.int32, device=S.device)
    NIFS.call("sp2_nifs_small_round", Ig, n, S.data_ptr(), E.data_ptr(), w.data_ptr(),
              partial.data_ptr(), nch, out.data_ptr(), field_words(spec))
    return limbs_to_ints(out, spec)


# ---------------------------------------------------------------------------
# the round driver
# ---------------------------------------------------------------------------


def run_nifs(spec: FieldSpec, A, B, C, E, rhos: list[int], round_cb, small=None):
    """Run the ell_b = log2(I) rounds on the grids A, B, C (I, n, 8), which
    are folded in place.  ``round_cb(t, e0, quad) -> r_b`` does the host's
    finish_round algebra and verifier-circuit round and returns the
    challenge.  ``small``: the small grid of a gated grid, for round 0.
    -> (r_bs, (Az, Bz, Cz) folded to one instance, each (n, 8))
    (NifsRoundsDevice.run, zk_device.py:486-518)."""
    ell_b = A.shape[0].bit_length() - 1
    if ell_b == 0:
        return [], (A[0], B[0], C[0])
    dev = A.device
    r_bs: list[int] = []
    for t in range(ell_b):
        cur = A.shape[0] if t == 0 else A.shape[0] // 2
        w = to_device([suffix_weight(spec, t, ell_b, q, rhos) for q in range(cur // 2)],
                      spec, dev, mont=True)
        if t == 0 and small is not None:
            e0, quad = small_round(small, E, w, spec)
        else:
            e0, quad = nifs_round(A, B, C, E, w, r_bs[-1] if t else 0, t > 0, spec)
            if t:
                A, B, C = A[:cur], B[:cur], C[:cur]
        r_bs.append(round_cb(t, e0, quad))
    nifs_fold(A, B, C, r_bs[-1], spec)
    return r_bs, (A[0], B[0], C[0])
