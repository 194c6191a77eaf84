// Kernel T: Keccak-256 and the device Fiat-Shamir transcript.
//
// Replaces the JAX package's keccak256_dev (spartan2_tpu/transcript/
// device.py:133), compute_updated_state_dev (:173) and the squeeze and
// scalar absorbs of DeviceTranscript (:184-257), with FieldOps'
// from_uniform_bytes (field/jnp_ops.py:302) and limbs_to_bytes (:722).
// The permutation and the squeeze are device functions (keccak.cuh), also
// inlined into every sum-check round's finish (round_finish.cu).
//
// Entries:
//   sp2_keccak256  n messages of len bytes each (row-major), one warp per
//                  message (keccak.cuh's permutation) -> n digests of 32
//                  bytes.
//   sp2_squeeze    one block: buf || DOM_SEP_TAG || round || state || label,
//                  built by the block's threads in shared memory, is hashed
//                  into the new 64-byte state (CUS, two warps); when chal is
//                  given, the state's from_uniform value in Montgomery form
//                  is written there (DeviceTranscript.squeeze_mont).  state
//                  may alias new_state.
//   sp2_fe_bytes   n Montgomery elements -> their canonical 32-byte
//                  encodings, little- or big-endian (the transcript's
//                  scalar absorbs are big-endian).
//
// Bound: a squeeze is a chain of 2 permutations (2 blocks; the two hashes
// run in two warps): latency, far from any rate of the card.

#include "field.cuh"
#include "keccak.cuh"

using namespace sp2;

constexpr int MAX_LABEL = 64;
constexpr int NT = 128;

struct Label {
  uint8_t b[MAX_LABEL];
  int len;
};

__global__ void keccak256_kernel(int n, int len, const uint8_t* msgs, uint8_t* out) {
  const int i = blockIdx.x * (NT / 32) + (threadIdx.x >> 5), l = threadIdx.x & 31;
  if (i >= n) return;  // the whole warp
  const uint8_t* m = msgs + (size_t)i * len;
  const uint64_t h = keccak256_warp([&](int w) { return message_word(m, len, w); }, len, -1);
  if (l < 4)
    for (int b = 0; b < 8; ++b) out[(size_t)i * 32 + 8 * l + b] = (uint8_t)(h >> (8 * b));
}

__global__ void squeeze_kernel(int buf_len, const uint8_t* buf, int round,
                               const uint8_t* state, Label label, uint8_t* new_state,
                               uint32_t* chal, Field F) {
  extern __shared__ uint8_t msg[];
  __shared__ uint64_t out[8];
  __shared__ uint8_t lab[MAX_LABEL];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < MAX_LABEL; ++i)  // static indices: the label stays a parameter
      if (i < label.len) lab[i] = label.b[i];
  }
  __syncthreads();
  const int len = buf_len + SQUEEZE_SUFFIX + label.len;
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    msg[i] = i < buf_len ? buf[i] : squeeze_suffix_byte(i - buf_len, round, state, lab);
  __syncthreads();
  cus_warps([&](int w) { return message_word(msg, len, w); }, len, out);
  __syncthreads();
  const uint8_t* o = reinterpret_cast<const uint8_t*>(out);
  if (threadIdx.x < 64) new_state[threadIdx.x] = o[threadIdx.x];
  if (threadIdx.x == 0 && chal != nullptr) fe_store(chal, 0, fe_from_uniform(o, F));
}

__global__ void fe_bytes_kernel(size_t n, const uint32_t* a, uint8_t* out, int big_endian,
                                Field F) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    uint8_t le[32];
    fe_to_le_bytes(fe_from_mont(fe_load(a, i), F), le);
    for (int k = 0; k < 32; ++k) out[32 * i + k] = le[big_endian ? 31 - k : k];
  }
}

extern "C" int sp2_keccak256(int n, int len, const void* msgs, void* out, void* stream) {
  if (n < 0 || len < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  keccak256_kernel<<<(n + NT / 32 - 1) / (NT / 32), NT, 0, (cudaStream_t)stream>>>(
      n, len, (const uint8_t*)msgs, (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int sp2_squeeze(int buf_len, const void* buf, int round, const void* state,
                           const uint8_t* label, int label_len, void* new_state,
                           void* chal, const uint32_t* field_words, void* stream) {
  const size_t smem = (size_t)buf_len + SQUEEZE_SUFFIX + MAX_LABEL;
  if (buf_len < 0 || label_len < 0 || label_len > MAX_LABEL || round < 0 ||
      round > 0xFFFF || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  Label lb;
  for (int i = 0; i < label_len; ++i) lb.b[i] = label[i];
  lb.len = label_len;
  squeeze_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(
      buf_len, (const uint8_t*)buf, round, (const uint8_t*)state, lb,
      (uint8_t*)new_state, (uint32_t*)chal, field_from_words(field_words));
  return (int)cudaGetLastError();
}

extern "C" int sp2_fe_bytes(size_t n, const void* a, void* out, int big_endian,
                            const uint32_t* field_words, void* stream) {
  if (n == 0) return 0;
  size_t blocks = (n + 127) / 128;
  fe_bytes_kernel<<<(unsigned)(blocks < 1024 ? blocks : 1024), 128, 0,
                    (cudaStream_t)stream>>>(n, (const uint32_t*)a, (uint8_t*)out,
                                            big_endian, field_from_words(field_words));
  return (int)cudaGetLastError();
}
