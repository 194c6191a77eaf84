// Kernel 4: the Hyrax row bind LZ[j] = sum_r L[r] * poly[r, j].
//
// Replaces the JAX package's hyrax_bind program (spartan2_tpu/pcs/
// hyrax.py HyraxPCS._bind_rows_device :300-327, hyrax bind_with_delayed).
// L (R scalars) and poly (R x C, row-major) are Montgomery form; the
// output is canonical (not Montgomery), ready to be the scalars of the
// comb MSM over [LZ, d_vec].
//
// Design, the JAX program's delayed reduction ("one wide reduction per
// column"): a block of HB_COLS consecutive columns x S row slices; thread
// (x, y) adds L[r] poly[r, j] for the rows r = y, y + S, ... unreduced
// into an Acc (fe_mul_acc).  A warp reads two rows' 16 neighbouring
// 32-byte elements, each a 512-byte run; every thread reads the same
// L[r], which the cache broadcasts.  The S slices' Accs are added by a
// tree in shared memory (acc_add), then each column takes one reduction
// (acc_reduce) and one fe_from_mont.  S = HB_MAX_SLICES (fewer when
// R is smaller: the next power of two at least R), so at the main path's
// 256 x 2048 the grid is 128 blocks of 512 threads, 8 rows a thread: the
// columns alone gave 2048 threads in 32 blocks, each thread a chain of
// 256 reduced products.  One launch a call.
//
// Bound: R * C unreduced products and a reduction and a from_mont a
// column (each half a Montgomery product) against R * C * 32 bytes read;
// at 256 x 2048 and the H100's rates the bytes bound it.

#include "field.cuh"

using namespace sp2;

constexpr int HB_COLS = 16;        // columns a block
constexpr int HB_MAX_SLICES = 32;  // row slices a block at most

// Row slices of a block over ``rows`` rows.
static int hb_slices(int rows) {
  int s = 1;
  while (s < rows && s < HB_MAX_SLICES) s <<= 1;
  return s;
}

__global__ void __launch_bounds__(HB_COLS * HB_MAX_SLICES)
    hyrax_bind_kernel(int rows, int ncols, const uint32_t* L, const uint32_t* poly,
                      uint32_t* out, Field F) {
  __shared__ Acc part[HB_MAX_SLICES][HB_COLS];
  const int x = threadIdx.x, y = threadIdx.y, S = blockDim.y;
  const int j = blockIdx.x * HB_COLS + x;
  Acc acc = acc_zero();
  if (j < ncols)
    for (int r = y; r < rows; r += S)
      fe_mul_acc(acc, fe_load(L, r), fe_load(poly, (size_t)r * ncols + j));
  part[y][x] = acc;
  __syncthreads();
  for (int s = S / 2; s > 0; s >>= 1) {
    if (y < s) {
      acc_add(acc, part[y + s][x]);
      part[y][x] = acc;
    }
    __syncthreads();
  }
  if (y == 0 && j < ncols) fe_store(out, j, fe_from_mont(acc_reduce(acc, F), F));
}

extern "C" int sp2_hyrax_bind(int rows, int ncols, const void* L, const void* poly,
                              void* out, const uint32_t* field_words, void* stream) {
  if (rows < 1 || ncols < 1) return (int)cudaErrorInvalidValue;
  const dim3 block(HB_COLS, hb_slices(rows));
  hyrax_bind_kernel<<<(ncols + HB_COLS - 1) / HB_COLS, block, 0, (cudaStream_t)stream>>>(
      rows, ncols, (const uint32_t*)L, (const uint32_t*)poly, (uint32_t*)out,
      field_from_words(field_words));
  return (int)cudaGetLastError();
}
