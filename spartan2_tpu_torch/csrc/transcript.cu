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
//   sp2_keccak256  n messages of len bytes each (row-major), one thread per
//                  message -> n digests of 32 bytes.
//   sp2_squeeze    one block: buf || DOM_SEP_TAG || round || state || label
//                  is hashed into the new 64-byte state (CUS); when chal is
//                  given, the state's from_uniform value in Montgomery form
//                  is written there (DeviceTranscript.squeeze_mont).  state
//                  may alias new_state.
//   sp2_fe_bytes   n Montgomery elements -> their canonical 32-byte
//                  encodings, little- or big-endian (the transcript's
//                  scalar absorbs are big-endian).
//
// Bound: a squeeze is a chain of 4 permutations (2 blocks, 2 hashes; the
// two hashes run in two threads), about 20 thousand 32-bit logic
// operations on one thread: latency, far from any rate of the card.

#include "field.cuh"
#include "keccak.cuh"

using namespace sp2;

constexpr int MAX_LABEL = 64;
constexpr int SQUEEZE_SUFFIX = 4 + 2 + 64 + MAX_LABEL;

struct Label {
  uint8_t b[MAX_LABEL];
  int len;
};

__global__ void keccak256_kernel(int n, int len, const uint8_t* msgs, uint8_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keccak256(msgs + (size_t)i * len, len, -1, out + (size_t)i * 32);
}

__global__ void squeeze_kernel(int buf_len, const uint8_t* buf, int round,
                               const uint8_t* state, Label label, uint8_t* new_state,
                               uint32_t* chal, Field F) {
  extern __shared__ uint8_t msg[];
  __shared__ uint8_t out[64];
  __shared__ int len;
  for (int i = threadIdx.x; i < buf_len; i += blockDim.x) msg[i] = buf[i];
  __syncthreads();
  if (threadIdx.x == 0)
    len = squeeze_message(msg, buf_len, round, state, label.b, label.len);
  __syncthreads();
  cus_half(msg, len, out);
  __syncthreads();
  if (threadIdx.x < 64) new_state[threadIdx.x] = out[threadIdx.x];
  if (threadIdx.x == 0 && chal != nullptr) fe_store(chal, 0, fe_from_uniform(out, F));
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
  keccak256_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      n, len, (const uint8_t*)msgs, (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int sp2_squeeze(int buf_len, const void* buf, int round, const void* state,
                           const uint8_t* label, int label_len, void* new_state,
                           void* chal, const uint32_t* field_words, void* stream) {
  const size_t smem = (size_t)buf_len + SQUEEZE_SUFFIX;
  if (buf_len < 0 || label_len < 0 || label_len > MAX_LABEL || round < 0 ||
      round > 0xFFFF || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  Label lb;
  for (int i = 0; i < label_len; ++i) lb.b[i] = label[i];
  lb.len = label_len;
  squeeze_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(
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
