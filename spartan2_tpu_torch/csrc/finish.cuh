// A launch's block sums finished in the launch: each block writes its
// sums to scratch, and the last block to arrive adds them, so a round's
// sums leave the kernel as one row an instance.  Kernel A and B
// (sumcheck.cu) and kernel G (cubiceq.cu) end this way; NeutronNova's
// rounds (nifs.cu) end with the instances weighted and added.
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

// Whether this block is the last of the launch to arrive, in every thread:
// an atomic ticket behind a fence, so the other blocks' writes are seen.
__device__ __forceinline__ bool last_to_arrive(unsigned* ticket) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// sum_b partial[k, b, t] in lane 0 of a warp, its lanes taking the blocks
// in turn.
template <int NS>
__device__ __forceinline__ Fe warp_block_sum(const uint32_t* partial, int k, int t, int lane,
                                             const Field& F) {
  Fe s = fe_zero();
  for (int b = lane; b < (int)gridDim.x; b += 32)
    s = fe_add_cc(s, fe_load_cg(partial, ((size_t)k * gridDim.x + b) * NS + t), F);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = fe_add_cc(s, fe_shfl_down(s, off), F);
  return s;
}

// The last block to arrive adds every block's partials, a warp a sum:
// out[k, t] = sum_b partial[k, b, t] over the instances k = blockIdx.y of
// the grid; it sets the ticket back to 0 for the next launch.  Field sums
// are exact, so the order the blocks arrive in does not matter.
template <int NS, int NT>
__device__ __forceinline__ void finish_sums(const uint32_t* partial, uint32_t* out,
                                            unsigned* ticket, const Field& F) {
  if (!last_to_arrive(ticket)) return;
  const int K = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int kt = warp; kt < K * NS; kt += NT / 32) {
    const int k = kt / NS, t = kt % NS;
    const Fe s = warp_block_sum<NS>(partial, k, t, lane, F);
    if (lane == 0) fe_store(out, kt, s);
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// As finish_sums, the instances then weighted and added: out[t] = sum_k
// w_k sum_b partial[k, b, t] (w (K, 8) Montgomery; the product is a
// Montgomery product).  Warp j takes the sums t = j mod NS of the instances
// k = j / NS, j / NS + NT / 32 / NS, ..., so a warp's lane 0 keeps one
// running sum; the warps' sums of each t are added in shared memory.
template <int NS, int NT>
__device__ __forceinline__ void finish_weighted_sums(const uint32_t* partial,
                                                     const uint32_t* w, uint32_t* out,
                                                     unsigned* ticket, const Field& F) {
  static_assert((NT / 32) % NS == 0, "a warp keeps one sum");
  constexpr int WPS = NT / 32 / NS;  // warps a sum
  __shared__ Fe ws[NT / 32];
  if (!last_to_arrive(ticket)) return;
  const int K = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = warp % NS;
  Fe acc = fe_zero();
  for (int k = warp / NS; k < K; k += WPS) {
    const Fe s = warp_block_sum<NS>(partial, k, t, lane, F);
    if (lane == 0) acc = fe_add_cc(acc, fe_mul_cc(fe_load(w, k), s, F), F);
  }
  if (lane == 0) ws[warp] = acc;
  __syncthreads();
  if (threadIdx.x < NS) {
    Fe o = fe_zero();
    for (int j = threadIdx.x; j < NT / 32; j += NS) o = fe_add_cc(o, ws[j], F);
    fe_store(out, threadIdx.x, o);
  }
  if (threadIdx.x == 0) *ticket = 0;
}

}  // namespace sp2
