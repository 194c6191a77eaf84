"""Sparse R1CS matrices: host CSR over Python ints, and the field SpMV.

``SparseMatrix`` is the host CSR the shape is built from and serialized
as (same layout and digest bytes as the JAX package's); its host SpMV
serves the verifier circuit's small shapes.  ``DeviceCSR``
holds one matrix on a device: int32 row offsets and column indices and
each coefficient in Montgomery form.  ``spmv``/``spmv_combine``/
``spmv_batched`` launch kernel 1 (csrc/spmv.cu) on CUDA tensors and run
the plain version on CPU tensors.  ``RowClasses`` lists the rows too long
for the kernel's thread per row, built once when a matrix goes to the
device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..field import ops
from ..field.constants import FieldSpec
from ..field.limbs import ints_to_limbs_np
from ..utils.cuda import SZ, CudaKernel, I, P, check_cuda, fe_words, field_words

_CSR_ARGS = [P, P, P, P, I, I]  # indptr, indices, vals, long rows, n_warp, n_block
SPMV = CudaKernel("spmv", {"sp2_spmv": [I, I] + _CSR_ARGS * 3 + [P, P, P, I, P, P],
                           "sp2_spmv_batched": [I, I, SZ] + _CSR_ARGS * 3 + [P, P, P]})

# Row classes of csrc/spmv.cu: a row of at most SHORT_ROW_MAX entries takes a
# thread, one of at most WARP_ROW_MAX a warp, a longer one a block.
SHORT_ROW_MAX = 16
WARP_ROW_MAX = 256


@dataclass
class SparseMatrix:
    """Host CSR matrix over python-int field elements (sparse.rs:385-539)."""

    field: FieldSpec
    data: list  # python ints (canonical)
    indices: list  # column per entry
    indptr: list  # row offsets, len = rows + 1
    cols: int = 0

    @classmethod
    def from_coo(cls, field: FieldSpec, entries, rows: int, cols: int) -> "SparseMatrix":
        """entries: iterable of (row, col, value)."""
        by_row = sorted(entries, key=lambda e: (e[0], e[1]))
        data, indices, indptr = [], [], [0]
        r = 0
        for row, col, val in by_row:
            while r < row:
                indptr.append(len(data))
                r += 1
            data.append(val % field.modulus)
            indices.append(col)
        while r < rows:
            indptr.append(len(data))
            r += 1
        return cls(field, data, indices, indptr, cols)

    @property
    def rows(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return len(self.data)

    def multiply_vec_host(self, z: list[int]) -> list[int]:
        """M z over Python ints (the verifier circuit's small shapes)."""
        p = self.field.modulus
        out = []
        for row in range(self.rows):
            s = 0
            for k in range(self.indptr[row], self.indptr[row + 1]):
                s += self.data[k] * z[self.indices[k]]
            out.append(s % p)
        return out

    def digest_bytes(self) -> bytes:
        """Deterministic bytes for vk digests (sparse write_digest_bytes)."""
        out = bytearray()
        out += len(self.data).to_bytes(8, "little")
        for v in self.data:
            out += self.field.to_bytes(v)
        out += len(self.indices).to_bytes(8, "little")
        for i in self.indices:
            out += int(i).to_bytes(8, "little")
        out += len(self.indptr).to_bytes(8, "little")
        for i in self.indptr:
            out += int(i).to_bytes(8, "little")
        out += int(self.cols).to_bytes(8, "little")
        return bytes(out)


def mont_values(m: SparseMatrix) -> np.ndarray:
    """(nnz, 8) int32 Montgomery coefficients; each distinct value is
    converted once (R1CS coefficients repeat heavily)."""
    lut: dict = {}
    idx = np.fromiter((lut.setdefault(v, len(lut)) for v in m.data),
                      np.int64, count=m.nnz)
    table = ints_to_limbs_np(list(lut), m.field, mont=True)
    return table.reshape(-1, 8)[idx] if m.nnz else np.zeros((0, 8), np.int32)


@dataclass
class RowClasses:
    """The long rows of a matrix (or of a row triple, each row's class
    that of its longest): ``long_rows`` (int32) holds the rows of
    SHORT_ROW_MAX + 1 to WARP_ROW_MAX entries ascending, then the longer
    ones ascending; ``n_warp`` counts the first part.  Every other row is
    short."""

    long_rows: torch.Tensor
    n_warp: int

    @classmethod
    def from_lengths(cls, lengths: np.ndarray, device) -> "RowClasses":
        lengths = np.asarray(lengths)
        warp = np.flatnonzero((lengths > SHORT_ROW_MAX) & (lengths <= WARP_ROW_MAX))
        block = np.flatnonzero(lengths > WARP_ROW_MAX)
        rows = np.concatenate([warp, block]).astype(np.int32)
        return cls(torch.from_numpy(rows).to(device), len(warp))

    @classmethod
    def joint(cls, mats: list) -> "RowClasses":
        """Classes of the row triples of ``spmv_combine``'s matrices."""
        lengths = np.maximum.reduce([np.diff(m.indptr.cpu().numpy()) for m in mats])
        return cls.from_lengths(lengths, mats[0].indptr.device)

    @property
    def n_block(self) -> int:
        return self.long_rows.shape[0] - self.n_warp

    def args(self) -> list:
        return [self.long_rows.data_ptr(), self.n_warp, self.n_block]


@dataclass
class DeviceCSR:
    """One sparse matrix on a device, Montgomery coefficients."""

    rows: int
    indptr: torch.Tensor  # (rows + 1,) int32
    indices: torch.Tensor  # (nnz,) int32, columns of the full z
    vals: torch.Tensor  # (nnz, 8) int32 Montgomery
    classes: RowClasses

    @classmethod
    def from_arrays(cls, rows_e: np.ndarray, cols_e: np.ndarray,
                    vals: np.ndarray, num_rows: int, device) -> "DeviceCSR":
        """Entries (row, col, Montgomery value), in any order."""
        order = np.lexsort((cols_e, rows_e))
        counts = np.bincount(rows_e, minlength=num_rows)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        return cls(
            rows=num_rows,
            indptr=torch.from_numpy(indptr).to(device),
            indices=torch.from_numpy(cols_e[order].astype(np.int32)).to(device),
            vals=torch.from_numpy(np.ascontiguousarray(vals[order])).to(device),
            classes=RowClasses.from_lengths(counts, device),
        )

    @classmethod
    def build(cls, m: SparseMatrix, device, col_min: int = 0,
              col_max: int | None = None, transpose_rows: int | None = None,
              mvals: np.ndarray | None = None) -> "DeviceCSR":
        """Device copy of ``m``, optionally keeping only the columns in
        [col_min, col_max) (indices keep their full-z numbering; the
        reference's build_filtered, sparse.rs:305-380) or transposed to
        ``transpose_rows`` rows."""
        indptr = np.asarray(m.indptr, np.int64)
        rows_e = np.repeat(np.arange(m.rows, dtype=np.int64), np.diff(indptr))
        cols_e = np.asarray(m.indices, np.int64)
        vals = mont_values(m) if mvals is None else mvals
        if transpose_rows is not None:
            return cls.from_arrays(cols_e, rows_e, vals, transpose_rows, device)
        hi = m.cols if col_max is None else col_max
        keep = (cols_e >= col_min) & (cols_e < hi)
        return cls.from_arrays(rows_e[keep], cols_e[keep], vals[keep], m.rows,
                               device)


def _spmv_plain_one(m: DeviceCSR, z: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    nnz = m.indices.shape[0]
    prod = ops.mont_mul(m.vals, z[m.indices.long()], spec)
    counts = (m.indptr[1:] - m.indptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(m.rows, device=z.device), counts)
    d = torch.zeros(16, m.rows, dtype=torch.int64, device=z.device)
    if nnz:
        d.index_add_(1, rows, ops.digits(prod))
    return ops.reduce_digit_sums(d, spec)


def spmv_plain(mats: list, z: torch.Tensor, spec: FieldSpec,
               prefix: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``spmv``."""
    out = torch.stack([_spmv_plain_one(m, z, spec) for m in mats])
    return out if prefix is None else ops.add(out, prefix, spec)


def spmv_combine_plain(mats: list, z: torch.Tensor, r: int,
                       spec: FieldSpec) -> torch.Tensor:
    """Plain version of ``spmv_combine``."""
    a, b, c = (_spmv_plain_one(m, z, spec) for m in mats)
    rr = ops.const(r, spec, device=z.device)
    return ops.add(a, ops.mont_mul(rr, ops.add(b, ops.mont_mul(rr, c, spec), spec),
                                   spec), spec)


def spmv_batched_plain(mats: list, z: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Plain version of ``spmv_batched``."""
    return torch.stack([spmv_plain(mats, zi, spec) for zi in z], 1)


def _launch(mats: list, z: torch.Tensor, spec: FieldSpec, prefix, r: int,
            combine: int, out: torch.Tensor, classes: RowClasses | None = None) -> None:
    rows = mats[0].rows
    if any(m.rows != rows for m in mats) or not 1 <= len(mats) <= 3:
        raise ValueError("spmv: 1 to 3 matrices with equal row counts")
    if combine and (len(mats) != 3 or classes is None):
        raise ValueError("spmv_combine: three matrices and their joint row classes")
    check_cuda(z, out, *(m.vals for m in mats),
               *([prefix] if prefix is not None else []))
    check_cuda(*(t for m in mats for t in (m.indptr, m.indices, m.classes.long_rows)),
               *([classes.long_rows] if classes is not None else []), dtype=torch.int32)
    if z.dim() not in (2, 3) or z.shape[-1] != 8:
        raise ValueError("spmv: z must be (n, 8) or (I, n, 8)")
    if prefix is not None and prefix.shape != (len(mats), rows, 8):
        raise ValueError("spmv: prefix must be (matrices, rows, 8)")
    ptrs = []
    for k in range(3):
        m = mats[min(k, len(mats) - 1)]
        ptrs += [m.indptr.data_ptr(), m.indices.data_ptr(), m.vals.data_ptr(),
                 *(classes if combine else m.classes).args()]
    if z.dim() == 3:  # I instances, A, B and C
        if len(mats) != 3 or prefix is not None or combine:
            raise ValueError("spmv_batched: three matrices, no prefix")
        SPMV.call("sp2_spmv_batched", rows, z.shape[0], z.shape[1], *ptrs, z.data_ptr(),
                  out.data_ptr(), field_words(spec))
        return
    SPMV.call("sp2_spmv", rows, len(mats), *ptrs, z.data_ptr(),
              prefix.data_ptr() if prefix is not None else None,
              fe_words(spec.to_mont(r)), combine, out.data_ptr(),
              field_words(spec))


def spmv(mats: list, z: torch.Tensor, spec: FieldSpec,
         prefix: torch.Tensor | None = None) -> torch.Tensor:
    """(k, rows, 8): out[y] = M_y z (+ prefix[y]) for k <= 3 matrices with
    equal row counts; Montgomery in, Montgomery out."""
    if z.device.type == "cpu":
        return spmv_plain(mats, z, spec, prefix)
    out = torch.empty(len(mats), mats[0].rows, 8, dtype=torch.int32,
                      device=z.device)
    _launch(mats, z, spec, prefix, 0, 0, out)
    return out


def spmv_combine(mats: list, z: torch.Tensor, r: int, spec: FieldSpec,
                 classes: RowClasses) -> torch.Tensor:
    """(rows, 8): M_0 z + r (M_1 z + r M_2 z) for a canonical scalar r;
    ``classes`` are the three matrices' joint row classes
    (``RowClasses.joint``, made once)."""
    if z.device.type == "cpu":
        return spmv_combine_plain(mats, z, r, spec)
    out = torch.empty(mats[0].rows, 8, dtype=torch.int32, device=z.device)
    _launch(mats, z, spec, None, r, 1, out, classes)
    return out


def spmv_batched(mats: list, z: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """(k, I, rows, 8): out[y, i] = M_y z[i] for I instances' vectors z
    (I, n, 8), one launch for every matrix and instance (the JAX
    package's spmv_apply_batched, r1cs/sparse.py:392)."""
    if z.device.type == "cpu":
        return spmv_batched_plain(mats, z, spec)
    if z.dim() != 3:
        raise ValueError("spmv_batched: z must be (I, n, 8)")
    out = torch.empty(len(mats), z.shape[0], mats[0].rows, 8, dtype=torch.int32,
                      device=z.device)
    _launch(mats, z, spec, None, 0, 0, out)
    return out
