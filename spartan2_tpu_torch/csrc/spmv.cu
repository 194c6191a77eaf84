// Kernel 1: sparse matrix-vector products over the field (CSR).
//
// Replaces the JAX package's scatter-free SpMV programs
// (spartan2_tpu/r1cs/sparse.py: spmv_apply :375, _spmv_accumulate :337,
// _reduce_lazy :405, spmv_apply_batched :392) in r1cs/shape.py
// shape_mv_pre :272, shape_mv_inc :288, shape_abc :313, shape_eval :344
// and shape_mv_batched :255.
//
// Layout: CSR with int32 row offsets and column indices, and each
// entry's coefficient in Montgomery form (8 words).  z and the output are
// canonical Montgomery (n, 8).
//
// Design: one warp per row.  Lanes stride over the row's entries,
// multiply coefficient by z[col] and add; a shuffle tree sums the lanes.
// The transposed matrices are badly skewed (the column of the constant
// ONE becomes a row with one entry per constraint that uses it), and a
// warp per row spreads such a row over 32 lanes instead of one thread.
// All sums are canonical adds, so no per-row entry budget applies.
//
// Epilogues (chosen by the wrapper):
//   combine == 0: out[y, i] = M_y z_i (+ prefix[y] when given), y =
//                 blockIdx.y, instance i = blockIdx.z of I, z_i = z +
//                 i * z_stride (one launch covers A, B and C of every
//                 instance; a prefix only with I = 1).  Entry sp2_spmv
//                 serves I = 1, sp2_spmv_batched I instances.
//   combine == 1: out = M_0 z + r * (M_1 z + r * M_2 z)   (poly_ABC)
//
// Bound: each entry moves 36 bytes of matrix plus a 32-byte gather and
// costs one Montgomery product (128 32x32-bit multiply-adds), so at
// these sizes the products bound it; short rows leave lanes idle.

#include "field.cuh"

using namespace sp2;

struct Csr {
  const int32_t* indptr;
  const int32_t* indices;
  const uint32_t* vals;
};

__device__ __forceinline__ Fe row_dot(const Csr& m, int row, int lane,
                                      const uint32_t* z, const Field& F) {
  Fe acc = fe_zero();
  const int lo = m.indptr[row];
  const int hi = m.indptr[row + 1];
  for (int k = lo + lane; k < hi; k += 32) {
    Fe v = fe_load(m.vals, k);
    Fe x = fe_load(z, m.indices[k]);
    acc = fe_add(acc, fe_mul(v, x, F), F);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc = fe_add(acc, fe_shfl_down(acc, off), F);
  return acc;  // valid in lane 0
}

__global__ void spmv_kernel(int rows, Csr m0, Csr m1, Csr m2, const uint32_t* z,
                            size_t z_stride, const uint32_t* prefix, Fe r,
                            int combine, uint32_t* out, Field F) {
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  z += (size_t)blockIdx.z * z_stride * 8;
  if (combine) {
    Fe a = row_dot(m0, row, lane, z, F);
    Fe b = row_dot(m1, row, lane, z, F);
    Fe c = row_dot(m2, row, lane, z, F);
    if (lane == 0) {
      Fe t = fe_add(b, fe_mul(r, c, F), F);
      fe_store(out, row, fe_add(a, fe_mul(r, t, F), F));
    }
    return;
  }
  const int y = blockIdx.y;
  const Csr& m = y == 0 ? m0 : (y == 1 ? m1 : m2);
  Fe s = row_dot(m, row, lane, z, F);
  if (lane == 0) {
    const size_t off = ((size_t)y * gridDim.z + blockIdx.z) * rows;
    if (prefix != nullptr) s = fe_add(s, fe_load(prefix, off + row), F);
    fe_store(out, off + row, s);
  }
}

static int launch(int rows, int nmat, int inst, size_t z_stride, Csr m0, Csr m1,
                  Csr m2, const void* z, const void* prefix, const uint32_t* r_words,
                  int combine, void* out, const uint32_t* field_words, void* stream) {
  Field F = field_from_words(field_words);
  if (inst < 1 || inst > 65535 || (inst > 1 && (combine || prefix != nullptr)))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;  // 8 rows per block
  dim3 grid((unsigned)((rows + 7) / 8), combine ? 1u : (unsigned)nmat, (unsigned)inst);
  if (rows > 0) {
    spmv_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        rows, m0, m1, m2, (const uint32_t*)z, z_stride, (const uint32_t*)prefix,
        fe_from_words(r_words), combine, (uint32_t*)out, F);
  }
  return (int)cudaGetLastError();
}

static Csr csr(const void* ip, const void* ix, const void* v) {
  return {(const int32_t*)ip, (const int32_t*)ix, (const uint32_t*)v};
}

extern "C" int sp2_spmv(int rows, int nmat, const void* ip0, const void* ix0,
                        const void* v0, const void* ip1, const void* ix1,
                        const void* v1, const void* ip2, const void* ix2,
                        const void* v2, const void* z, const void* prefix,
                        const uint32_t* r_words, int combine, void* out,
                        const uint32_t* field_words, void* stream) {
  return launch(rows, nmat, 1, 0, csr(ip0, ix0, v0), csr(ip1, ix1, v1),
                csr(ip2, ix2, v2), z, prefix, r_words, combine, out, field_words,
                stream);
}

// Az, Bz, Cz of I instances (shape_mv_batched): out (3, I, rows).
extern "C" int sp2_spmv_batched(int rows, int inst, size_t z_stride, const void* ip0,
                                const void* ix0, const void* v0, const void* ip1,
                                const void* ix1, const void* v1, const void* ip2,
                                const void* ix2, const void* v2, const void* z,
                                const uint32_t* r_words, void* out,
                                const uint32_t* field_words, void* stream) {
  return launch(rows, 3, inst, z_stride, csr(ip0, ix0, v0), csr(ip1, ix1, v1),
                csr(ip2, ix2, v2), z, nullptr, r_words, 0, out, field_words, stream);
}
