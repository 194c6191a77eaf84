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
the small-value gate, else on kernel 3 like the other rounds.  The
rounds never write their input grid (the prep cache's): each fold goes
to an output grid of its own.

On CUDA tensors each wrapper launches its kernel or raises; on CPU
tensors it runs the plain version.
"""

from __future__ import annotations

import struct

import torch

from ..field import ops
from ..field.constants import FieldSpec
from ..field.limbs import limbs_to_ints, to_device
from ..field.small_value import small_round_plain, to_small_plain
from ..utils.cuda import SZ, CudaKernel, I, P, check_cuda, fe_words, field_words
from .device import new_ticket

NIFS = CudaKernel("nifs", {
    "sp2_nifs_round": [I, SZ, I, P, P, P, P, P, P, P, P, P, P, I, P, P, P],
    "sp2_nifs_fold": [I, SZ, P, P, P, P, P, P, P, P],
    "sp2_weighted_fold": [I, SZ, P, P, I, P, P],
    "sp2_nifs_to_small": [SZ, P, P, P, P, P, P],
    "sp2_nifs_small_round": [I, SZ, P, P, P, P, I, P, P, P],
})

_NT = 256
# a round's grid (csrc/nifs.cu nifs_blocks): the pairs on the grid's rows,
# each over the largest power of two of blocks keeping all within
# _NIFS_MAX_BLOCKS, at most a column a thread
_NIFS_MAX_BLOCKS = 264
# the weighted fold's rows a launch, passed by value (csrc/nifs.cu WF_MAX_ROWS)
_WF_MAX_ROWS = 256


def _nifs_blocks(pairs: int, n: int) -> int:
    """Blocks a pair of a round, as csrc/nifs.cu's nifs_blocks, which
    refuses another."""
    cap = 1
    while cap * 2 * pairs <= _NIFS_MAX_BLOCKS:
        cap *= 2
    return max(1, min(-(-n // _NT), cap))


def _check_grid(A, B, C) -> None:
    check_cuda(A, B, C)
    if A.dim() != 3 or A.shape[-1] != 8 or A.shape != B.shape or A.shape != C.shape:
        raise ValueError("nifs: A, B, C must be (I, n, 8) of one shape")


def _span(t: torch.Tensor) -> tuple[int, int]:
    return t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()


def _fold_out(grid, out, rows: int):
    """The fold's output grid ``out`` (three (rows, n, 8) tensors, or one
    (3, rows, n, 8)) -> its three rows, checked: shape, and no byte shared
    with the input grid (a fold never writes in place)."""
    if out is None:
        raise ValueError("nifs: a fold needs its output grid")
    outs = tuple(out)
    want = (rows,) + tuple(grid[0].shape[1:])
    if len(outs) != 3 or any(tuple(o.shape) != want for o in outs):
        raise ValueError(f"nifs: the fold's output must be 3 grids of {want}")
    for o in outs:
        lo, hi = _span(o)
        for x in grid:
            xlo, xhi = _span(x)
            if lo < xhi and xlo < hi:
                raise ValueError("nifs: the fold's output overlaps its input grid")
    return outs


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


def _fold_plain(grids, r: int, spec: FieldSpec, outs) -> None:
    """Rows (2i, 2i + 1) of each grid -> row i of its output grid."""
    rr = ops.const(r, spec, device=grids[0].device)
    for X, Y in zip(grids, outs):
        even, odd = X[0::2], X[1::2]
        Y.copy_(ops.add(even, ops.mont_mul(rr, ops.sub(odd, even, spec), spec), spec))


def nifs_round_plain(A, B, C, E, w, r: int, bind_first: bool, spec: FieldSpec,
                     out=None) -> torch.Tensor:
    """Plain version of ``nifs_round``: (2, 8) Montgomery [e0, quad]."""
    if bind_first:
        outs = _fold_out((A, B, C), out, A.shape[0] // 2)
        _fold_plain((A, B, C), r, spec, outs)
        A, B, C = outs
    Ae, Ao, Be, Bo, Ce = A[0::2], A[1::2], B[0::2], B[1::2], C[0::2]
    e0 = ops.mont_mul(E, ops.sub(ops.mont_mul(Ae, Be, spec), Ce, spec), spec)
    quad = ops.mont_mul(E, ops.mont_mul(ops.sub(Ao, Ae, spec), ops.sub(Bo, Be, spec),
                                        spec), spec)
    res = []
    for g in (e0, quad):
        sums = torch.stack([ops.sum_all(x, spec) for x in g])  # (pairs, 8)
        res.append(ops.sum_all(ops.mont_mul(w, sums, spec), spec))
    return torch.stack(res)


def nifs_round(A, B, C, E, w, r: int, bind_first: bool, spec: FieldSpec, out=None,
               ticket=None) -> list[int]:
    """Kernel 3's round, one launch.  A, B, C: (I, n, 8) Montgomery grids,
    only read; if ``bind_first``, instances (2i, 2i + 1) are first folded
    with the canonical challenge r into row i of ``out`` (three (I/2, n, 8)
    grids or one (3, I/2, n, 8), sharing no byte with A, B, C), which the
    sums then read.  Over the pairs q of that grid: [e0, quad] =
    sum_q w_q [sum_k E_k (Ae Be - Ce), sum_k E_k (Ao - Ae)(Bo - Be)], E
    (n, 8) and w (pairs, 8) Montgomery; -> canonical ints.  ``ticket``
    (``new_ticket``) may serve every round of a prove."""
    if A.device.type == "cpu":
        return limbs_to_ints(nifs_round_plain(A, B, C, E, w, r, bind_first, spec, out),
                             spec, mont=True)
    _check_grid(A, B, C)
    check_cuda(E, w)
    Ig, n = A.shape[0], A.shape[1]
    pairs = (Ig // 2 if bind_first else Ig) // 2
    if E.shape != (n, 8) or w.shape != (pairs, 8) or pairs < 1:
        raise ValueError("nifs_round: E must be (n, 8) and w (pairs, 8)")
    outs = (None, None, None)
    if bind_first:
        outs = _fold_out((A, B, C), out, Ig // 2)
        check_cuda(*outs)
    nb = _nifs_blocks(pairs, n)
    partial = torch.empty(pairs * nb * 2, 8, dtype=torch.int32, device=A.device)
    res = torch.empty(2, 8, dtype=torch.int32, device=A.device)
    if ticket is None:
        ticket = new_ticket(A.device)
    NIFS.call("sp2_nifs_round", Ig, n, int(bind_first), fe_words(spec.to_mont(r)),
              A.data_ptr(), B.data_ptr(), C.data_ptr(),
              *(o.data_ptr() if o is not None else None for o in outs), E.data_ptr(),
              w.data_ptr(), partial.data_ptr(), nb, res.data_ptr(), ticket.data_ptr(),
              field_words(spec))
    return limbs_to_ints(res, spec, mont=True)


def nifs_fold(A, B, C, r: int, spec: FieldSpec, out) -> None:
    """Kernel 3's fold alone: rows (2i, 2i + 1) of the (I, n, 8) grids ->
    row i of ``out`` with the canonical challenge r (the final fold, I = 2
    -> 1); ``out`` as ``nifs_round``'s."""
    outs = _fold_out((A, B, C), out, A.shape[0] // 2)
    if A.device.type == "cpu":
        _fold_plain((A, B, C), r, spec, outs)
        return
    _check_grid(A, B, C)
    check_cuda(*outs)
    NIFS.call("sp2_nifs_fold", A.shape[0], A.shape[1], fe_words(spec.to_mont(r)),
              A.data_ptr(), B.data_ptr(), C.data_ptr(), *(o.data_ptr() for o in outs),
              field_words(spec))


def weighted_fold_plain(W: torch.Tensor, w: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Plain version of ``weighted_fold``, on the rows stacked (I, n, 8)."""
    acc = ops.mont_mul(w[0], W[0], spec)
    for i in range(1, W.shape[0]):
        acc = ops.add(acc, ops.mont_mul(w[i], W[i], spec), spec)
    return acc


def weighted_fold(rows, w: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Kernel 3's weighted fold: I rows of (n, 8) Montgomery elements (a
    sequence of tensors, or one (I, n, 8)) and (I, 8) Montgomery weights ->
    (n, 8) Montgomery sum_i w_i W_i.  The kernel reads the rows where they
    lie, by their addresses, _WF_MAX_ROWS a launch."""
    rows = list(rows)
    if rows[0].device.type == "cpu":
        return weighted_fold_plain(torch.stack(rows), w, spec)
    check_cuda(w, *rows)
    n = rows[0].shape[0]
    if any(tuple(x.shape) != (n, 8) for x in rows) or w.shape != (len(rows), 8):
        raise ValueError("weighted_fold: I rows (n, 8) and w (I, 8)")
    out = torch.empty(n, 8, dtype=torch.int32, device=w.device)
    for c in range(0, len(rows), _WF_MAX_ROWS):
        chunk = rows[c : c + _WF_MAX_ROWS]
        ptrs = struct.pack(f"<{len(chunk)}Q", *(x.data_ptr() for x in chunk))
        NIFS.call("sp2_weighted_fold", len(chunk), n, w[c:].data_ptr(), ptrs, int(c > 0),
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


def small_round(S: torch.Tensor, E: torch.Tensor, w: torch.Tensor, spec: FieldSpec,
                ticket=None) -> list[int]:
    """Kernel 4's round 0 from the small grid S (3, I, n, 4) (of a grid
    that passed the gate), one launch: the same [e0, quad] as
    ``nifs_round`` without a fold, by exact integer products; -> canonical
    ints."""
    if S.device.type == "cpu":
        return limbs_to_ints(small_round_plain(S, E, w, spec), spec)
    check_cuda(S, E, w)
    Ig, n = S.shape[1], S.shape[2]
    pairs = Ig // 2
    if S.shape != (3, Ig, n, 4) or E.shape != (n, 8) or w.shape != (pairs, 8):
        raise ValueError("small_round: S (3, I, n, 4), E (n, 8), w (I/2, 8)")
    nb = _nifs_blocks(pairs, n)
    partial = torch.empty(pairs * nb * 2, 8, dtype=torch.int32, device=S.device)
    out = torch.empty(2, 8, dtype=torch.int32, device=S.device)
    if ticket is None:
        ticket = new_ticket(S.device)
    NIFS.call("sp2_nifs_small_round", Ig, n, S.data_ptr(), E.data_ptr(), w.data_ptr(),
              partial.data_ptr(), nb, out.data_ptr(), ticket.data_ptr(), field_words(spec))
    return limbs_to_ints(out, spec)


# ---------------------------------------------------------------------------
# the round driver
# ---------------------------------------------------------------------------


def run_nifs(spec: FieldSpec, A, B, C, E, rhos: list[int], round_cb, small=None):
    """Run the ell_b = log2(I) rounds on the grids A, B, C (I, n, 8), which
    are only read (the prep cache's grid): round t >= 1 folds into one of
    two buffers of I/2 and I/4 rows, in turn, and the final fold into a
    third.  ``round_cb(t, e0, quad) -> r_b`` does the host's finish_round
    algebra and verifier-circuit round and returns the challenge.
    ``small``: the small grid of a gated grid, for round 0.
    -> (r_bs, (Az, Bz, Cz) folded to one instance, each (n, 8), in a buffer
    of their own; with one instance, copies of the grid's rows)
    (NifsRoundsDevice.run, zk_device.py:486-518)."""
    Ig, n = A.shape[0], A.shape[1]
    ell_b = Ig.bit_length() - 1
    if ell_b == 0:
        return [], (A[0].clone(), B[0].clone(), C[0].clone())
    dev = A.device
    bufs = [torch.empty(3, Ig >> t, n, 8, dtype=torch.int32, device=dev)
            for t in (1, 2) if ell_b > t]
    ticket = new_ticket(dev)
    grid = (A, B, C)
    r_bs: list[int] = []
    for t in range(ell_b):
        pairs = (Ig >> t) // 2
        w = to_device([suffix_weight(spec, t, ell_b, q, rhos) for q in range(pairs)],
                      spec, dev, mont=True)
        if t == 0 and small is not None:
            e0, quad = small_round(small, E, w, spec, ticket)
        elif t == 0:
            e0, quad = nifs_round(*grid, E, w, 0, False, spec, ticket=ticket)
        else:
            out = bufs[(t - 1) % 2][:, : Ig >> t]
            e0, quad = nifs_round(*grid, E, w, r_bs[-1], True, spec, out, ticket)
            grid = tuple(out)
        r_bs.append(round_cb(t, e0, quad))
    fin = torch.empty(3, 1, n, 8, dtype=torch.int32, device=dev)
    nifs_fold(*grid, r_bs[-1], spec, fin)
    return r_bs, (fin[0, 0], fin[1, 0], fin[2, 0])
