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
// canonical Montgomery (n, 8).  Beside each matrix, its long rows: an
// int32 list built once when the matrix goes to the device
// (r1cs/sparse.py RowClasses), first the rows of SHORT_ROW_MAX + 1 to
// WARP_ROW_MAX entries, then the longer ones, each part ascending.
//
// Design: a class of rows for each grain of parallelism.
//   short rows (at most SHORT_ROW_MAX = 16 entries): one thread per row,
//     consecutive threads on consecutive rows.  The thread loops over its
//     entries (an index, a 32-byte gather of z, a 32-byte coefficient, one
//     product, one canonical add); no shuffles.  An empty row writes 0 or
//     its prefix.  A long row is skipped: its length, read from indptr,
//     says so, and a later launch writes it.
//   warp rows (17 to WARP_ROW_MAX = 256 entries): a warp per listed row,
//     lanes stride over the entries, a shuffle tree sums the lanes.
//   block rows (more than 256): a 256-thread block per listed row,
//     block_sum over its warps.
// At SHA-256 1 KiB the R1CS rows hold 1.1, 0.6 and 1.0 entries on
// average and half are empty padding; A's 5304 packing rows (up to 164
// entries) are warp rows; in the transposes every row has at most 7
// entries but the column of the constant ONE (1173 / 5729 / 47 entries
// in A / B / C), a block row of A and B.  L = 16 sits in the gap between
// 7 and A's shortest long row.
// One entry call makes all three launches on the current stream (the
// second and third only when rows of their class exist) and counts once.
//
// Epilogues (chosen by the wrapper):
//   combine == 0: out[y, i] = M_y z_i (+ prefix[y] when given), y =
//                 blockIdx.y, instance i = blockIdx.z of I, z_i = z +
//                 i * z_stride (one launch covers A, B and C of every
//                 instance; a prefix only with I = 1).  Each matrix has
//                 its own classes.  Entry sp2_spmv serves I = 1,
//                 sp2_spmv_batched I instances.
//   combine == 1: out = M_0 z + r * (M_1 z + r * M_2 z)   (poly_ABC); a
//                 row's class is that of the longest of its three rows,
//                 and the joint list comes in matrix 0's slot.
// All sums are canonical adds, exact in any order.
//
// Bound: each entry moves 36 bytes of matrix plus a 32-byte gather and
// costs one Montgomery product (128 32x32-bit multiply-adds).

#include "field.cuh"

using namespace sp2;

constexpr int SHORT_ROW_MAX = 16;  // r1cs/sparse.py SHORT_ROW_MAX
constexpr int NT = 256;            // threads of every block here

struct Csr {
  const int32_t* indptr;
  const int32_t* indices;
  const uint32_t* vals;
  const int32_t* long_rows;  // n_warp warp rows, then n_block block rows
  int n_warp;
  int n_block;
};

struct Args {
  int rows;
  Csr m0, m1, m2;
  const uint32_t* z;
  size_t z_stride;
  const uint32_t* prefix;
  Fe r;
  int combine;
  uint32_t* out;
};

__device__ __forceinline__ const Csr& mat(const Args& a, int y) {
  return y == 0 ? a.m0 : (y == 1 ? a.m1 : a.m2);
}

__device__ __forceinline__ int row_len(const Csr& m, int row) {
  return m.indptr[row + 1] - m.indptr[row];
}

// Sum over this thread's share of a row's entries (t, t + stride, ...).
__device__ __forceinline__ Fe dot_part(const Csr& m, int row, int t, int stride,
                                       const uint32_t* z, const Field& F) {
  Fe acc = fe_zero();
  const int hi = m.indptr[row + 1];
  for (int k = m.indptr[row] + t; k < hi; k += stride)
    acc = fe_add(acc, fe_mul(fe_load(m.vals, k), fe_load(z, m.indices[k]), F), F);
  return acc;
}

// The row's one (or, combining, three) partial dot products.
__device__ __forceinline__ void row_parts(const Args& a, int y, int row, int t,
                                          int stride, const uint32_t* z, Fe* s,
                                          const Field& F) {
  if (a.combine) {
#pragma unroll
    for (int j = 0; j < 3; ++j) s[j] = dot_part(mat(a, j), row, t, stride, z, F);
  } else {
    s[0] = dot_part(mat(a, y), row, t, stride, z, F);
  }
}

__device__ __forceinline__ void row_store(const Args& a, int y, int row, const Fe* s,
                                          const Field& F) {
  if (a.combine) {
    Fe t = fe_add(s[1], fe_mul(a.r, s[2], F), F);
    fe_store(a.out, row, fe_add(s[0], fe_mul(a.r, t, F), F));
    return;
  }
  const size_t off = ((size_t)y * gridDim.z + blockIdx.z) * a.rows + row;
  Fe v = s[0];
  if (a.prefix != nullptr) v = fe_add(v, fe_load(a.prefix, off), F);
  fe_store(a.out, off, v);
}

__device__ __forceinline__ const uint32_t* instance_z(const Args& a) {
  return a.z + (size_t)blockIdx.z * a.z_stride * 8;
}

__global__ void spmv_short_kernel(Args a, Field F) {
  const int row = blockIdx.x * NT + threadIdx.x;
  if (row >= a.rows) return;
  const int y = blockIdx.y;  // 0 when combining
  if (a.combine) {
    if (row_len(a.m0, row) > SHORT_ROW_MAX || row_len(a.m1, row) > SHORT_ROW_MAX ||
        row_len(a.m2, row) > SHORT_ROW_MAX)
      return;
  } else if (row_len(mat(a, y), row) > SHORT_ROW_MAX) {
    return;
  }
  Fe s[3];
  row_parts(a, y, row, 0, 1, instance_z(a), s, F);
  row_store(a, y, row, s, F);
}

__global__ void spmv_warp_kernel(Args a, Field F) {
  const int y = blockIdx.y;
  const Csr& m = mat(a, y);
  const int w = (int)((blockIdx.x * (size_t)NT + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= m.n_warp) return;  // whole warps leave together
  const int row = m.long_rows[w];
  Fe s[3];
  row_parts(a, y, row, lane, 32, instance_z(a), s, F);
  const int n = a.combine ? 3 : 1;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (j < n) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s[j] = fe_add(s[j], fe_shfl_down(s[j], off), F);
    }
  }
  if (lane == 0) row_store(a, y, row, s, F);
}

__global__ void spmv_block_kernel(Args a, Field F) {
  const int y = blockIdx.y;
  const Csr& m = mat(a, y);
  if ((int)blockIdx.x >= m.n_block) return;  // the whole block leaves
  const int row = m.long_rows[m.n_warp + blockIdx.x];
  Fe s[3];
  row_parts(a, y, row, threadIdx.x, NT, instance_z(a), s, F);
  const int n = a.combine ? 3 : 1;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    if (j < n) s[j] = block_sum<NT>(s[j], F);
  if (threadIdx.x == 0) row_store(a, y, row, s, F);
}

static int launch(Args a, int nmat, int inst, const uint32_t* field_words,
                  void* stream) {
  Field F = field_from_words(field_words);
  if (inst < 1 || inst > 65535 || (inst > 1 && (a.combine || a.prefix != nullptr)))
    return (int)cudaErrorInvalidValue;
  if (a.rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int ny = a.combine ? 1 : nmat;
  int n_warp = 0, n_block = 0;
  const Csr ms[3] = {a.m0, a.m1, a.m2};
  for (int y = 0; y < ny; ++y) {
    n_warp = ms[y].n_warp > n_warp ? ms[y].n_warp : n_warp;
    n_block = ms[y].n_block > n_block ? ms[y].n_block : n_block;
  }
  spmv_short_kernel<<<dim3((unsigned)((a.rows + NT - 1) / NT), (unsigned)ny,
                           (unsigned)inst), NT, 0, s>>>(a, F);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if (n_warp > 0) {
    const size_t threads = (size_t)n_warp * 32;
    spmv_warp_kernel<<<dim3((unsigned)((threads + NT - 1) / NT), (unsigned)ny,
                            (unsigned)inst), NT, 0, s>>>(a, F);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (n_block > 0) {
    spmv_block_kernel<<<dim3((unsigned)n_block, (unsigned)ny, (unsigned)inst), NT, 0,
                        s>>>(a, F);
    err = (int)cudaGetLastError();
  }
  return err;
}

static Csr csr(const void* ip, const void* ix, const void* v, const void* lr,
               int n_warp, int n_block) {
  return {(const int32_t*)ip, (const int32_t*)ix, (const uint32_t*)v,
          (const int32_t*)lr, n_warp, n_block};
}

#define SP2_CSR_PARAMS(k)                                                       \
  const void *ip##k, const void *ix##k, const void *v##k, const void *lr##k,    \
      int nw##k, int nb##k
#define SP2_CSR(k) csr(ip##k, ix##k, v##k, lr##k, nw##k, nb##k)

extern "C" int sp2_spmv(int rows, int nmat, SP2_CSR_PARAMS(0), SP2_CSR_PARAMS(1),
                        SP2_CSR_PARAMS(2), const void* z, const void* prefix,
                        const uint32_t* r_words, int combine, void* out,
                        const uint32_t* field_words, void* stream) {
  Args a{rows, SP2_CSR(0), SP2_CSR(1), SP2_CSR(2), (const uint32_t*)z, 0,
         (const uint32_t*)prefix, fe_from_words(r_words), combine, (uint32_t*)out};
  return launch(a, nmat, 1, field_words, stream);
}

// Az, Bz, Cz of I instances (shape_mv_batched): out (3, I, rows).
extern "C" int sp2_spmv_batched(int rows, int inst, size_t z_stride, SP2_CSR_PARAMS(0),
                                SP2_CSR_PARAMS(1), SP2_CSR_PARAMS(2), const void* z,
                                void* out, const uint32_t* field_words, void* stream) {
  Args a{rows, SP2_CSR(0), SP2_CSR(1), SP2_CSR(2), (const uint32_t*)z, z_stride,
         nullptr, fe_zero_host(), 0, (uint32_t*)out};
  return launch(a, 3, inst, field_words, stream);
}
