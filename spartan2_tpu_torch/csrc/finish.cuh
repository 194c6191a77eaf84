// A launch's block sums finished in the launch: each block writes its
// sums to scratch, and the last block to arrive adds them, so a round's
// sums leave the kernel as one row an instance.  Kernel A and B
// (sumcheck.cu) and kernel G (cubiceq.cu) end this way.
#pragma once

#include "field.cuh"

namespace sp2 {

// This block's NS sums of instance k into partial[k, block, t] (a block of
// NT threads; the sums of every thread's s[] are added first).
template <int NS, int NT>
__device__ __forceinline__ void store_block_sums(int k, Fe* s, uint32_t* partial,
                                                 const Field& F) {
  block_sums<NT, NS>(s, F);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int t = 0; t < NS; ++t)
      fe_store(partial, ((size_t)k * gridDim.x + blockIdx.x) * NS + t, s[t]);
  }
}

// The last block to arrive (an atomic ticket behind a fence) adds every
// block's partials, a warp a sum: out[k, t] = sum_b partial[k, b, t] over
// the instances k = blockIdx.y of the grid; it
// sets the ticket back to 0 for the next launch.  Field sums are exact, so
// the order the blocks arrive in does not matter.
template <int NS, int NT>
__device__ __forceinline__ void finish_sums(const uint32_t* partial, uint32_t* out,
                                            unsigned* ticket, const Field& F) {
  __shared__ int last;
  const int K = gridDim.y;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int kt = warp; kt < K * NS; kt += NT / 32) {
    const int k = kt / NS, t = kt % NS;
    Fe s = fe_zero();
    for (int b = lane; b < (int)gridDim.x; b += 32)
      s = fe_add_cc(s, fe_load_cg(partial, ((size_t)k * gridDim.x + b) * NS + t), F);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = fe_add_cc(s, fe_shfl_down(s, off), F);
    if (lane == 0) fe_store(out, kt, s);
  }
  if (threadIdx.x == 0) *ticket = 0;
}

}  // namespace sp2
