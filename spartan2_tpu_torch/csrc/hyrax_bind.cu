// Kernel 4: the Hyrax row bind LZ[j] = sum_r L[r] * poly[r, j].
//
// Replaces the JAX package's hyrax_bind program (spartan2_tpu/pcs/
// hyrax.py HyraxPCS._bind_rows_device :300).  L (R scalars) and poly
// (R x C, row-major) are Montgomery form; the output is canonical
// (not Montgomery), ready to be the scalars of the comb MSM over
// [LZ, d_vec].
//
// Design: one thread per column j loops over the R rows with a Montgomery
// multiply-accumulate.  Neighbouring threads read neighbouring 32-byte
// elements of a row, so each row is one coalesced sweep; every thread
// reads the same L[r], which the cache broadcasts.
//
// Bound: R * C Montgomery products against R * C * 32 bytes read; at
// 256 x 2048 the products bound it.

#include "field.cuh"

using namespace sp2;

__global__ void hyrax_bind_kernel(int rows, int ncols, const uint32_t* L,
                                  const uint32_t* poly, uint32_t* out, Field F) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ncols) return;
  Fe acc = fe_zero();
  for (int r = 0; r < rows; ++r)
    acc = fe_add(acc, fe_mul(fe_load(L, r), fe_load(poly, (size_t)r * ncols + j), F), F);
  fe_store(out, j, fe_from_mont(acc, F));
}

extern "C" int sp2_hyrax_bind(int rows, int ncols, const void* L, const void* poly,
                              void* out, const uint32_t* field_words, void* stream) {
  Field F = field_from_words(field_words);
  const int nt = 64;
  hyrax_bind_kernel<<<(ncols + nt - 1) / nt, nt, 0, (cudaStream_t)stream>>>(
      rows, ncols, (const uint32_t*)L, (const uint32_t*)poly, (uint32_t*)out, F);
  return (int)cudaGetLastError();
}
