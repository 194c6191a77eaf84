// Keccak-256 and the Fiat-Shamir squeeze as device functions (kernel T),
// inlined into csrc/transcript.cu and the round finish (csrc/round_finish.cu).
//
// Replaces the JAX package's device Keccak and transcript
// (spartan2_tpu/transcript/device.py: keccak_f1600_dev :67, keccak256_dev
// :133, compute_updated_state_dev :173, DeviceTranscript.squeeze_bytes
// :235-252).  The TPU has no 64-bit integers, so JAX kept each lane as a
// pair of uint32 planes; here a lane is a native uint64_t, the 25 lanes
// stay in registers (every lane index is a compile-time constant once the
// loops unroll), and one thread hashes one message.  The permutation is
// the reference Keccak-f[1600] (tiny_sha3's lane order: A[x][y] =
// st[x + 5 y]); padding is the original Keccak's 0x01 .. 0x80 (0x81 when
// one byte is left), rate 136 bytes.
//
// Bound: a permutation is about 24 x 200 64-bit logic operations in one
// thread's dependency chain, so a squeeze (two hashes of 2 blocks each
// for a sum-check round) is latency, not throughput.
#pragma once

#include <cstdint>

namespace sp2 {

__constant__ uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

constexpr int KECCAK_RATE = 136;

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) {
  return (x << n) | (x >> (64 - n));
}

__device__ __forceinline__ void keccak_f1600(uint64_t st[25]) {
  // rho offsets and pi lane order along the pi cycle starting at lane 1
  constexpr int ROTC[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                            27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
  constexpr int PILN[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                            15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};
  for (int rnd = 0; rnd < 24; ++rnd) {
    uint64_t bc[5];
    // theta
#pragma unroll
    for (int i = 0; i < 5; ++i)
      bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const uint64_t t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
#pragma unroll
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    // rho and pi
    uint64_t t = st[1];
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const uint64_t b = st[PILN[i]];
      st[PILN[i]] = rotl64(t, ROTC[i]);
      t = b;
    }
    // chi
#pragma unroll
    for (int j = 0; j < 25; j += 5) {
#pragma unroll
      for (int i = 0; i < 5; ++i) bc[i] = st[j + i];
#pragma unroll
      for (int i = 0; i < 5; ++i) st[j + i] ^= (~bc[(i + 1) % 5]) & bc[(i + 2) % 5];
    }
    // iota
    st[0] ^= KECCAK_RC[rnd];
  }
}

// Keccak-256 of msg[0, len) followed by the byte ``extra`` (none when
// extra < 0), 32 bytes to out.  Bytes are gathered lane by lane so that
// every lane index is static and the state stays in registers.
__device__ __forceinline__ void keccak256(const uint8_t* msg, int len, int extra,
                                          uint8_t* out) {
  uint64_t st[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) st[i] = 0;
  const int total = len + (extra >= 0 ? 1 : 0);
  for (int off = 0;; off += KECCAK_RATE) {
    const bool last = total - off < KECCAK_RATE;
#pragma unroll
    for (int w = 0; w < KECCAK_RATE / 8; ++w) {
      uint64_t lane = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int k = off + 8 * w + b;
        uint32_t v = k < len ? msg[k] : (k == len && extra >= 0 ? (uint32_t)extra : 0u);
        if (last && k == total) v ^= 0x01u;              // first padding byte
        if (last && 8 * w + b == KECCAK_RATE - 1) v ^= 0x80u;  // last one
        lane |= (uint64_t)(v & 0xFFu) << (8 * b);
      }
      st[w] ^= lane;
    }
    keccak_f1600(st);
    if (last) break;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) out[i] = (uint8_t)(st[i >> 3] >> (8 * (i & 7)));
}

// Append the squeeze suffix DOM_SEP_TAG || round (u16 LE) || state (64 B)
// || label to the n buffered bytes at m; -> the message length.  The
// message is then hashed twice: CUS(m) = keccak256(m || 0x00) ||
// keccak256(m || 0x01) (transcript.py _compute_updated_state).
__device__ __forceinline__ int squeeze_message(uint8_t* m, int n, int round,
                                               const uint8_t* state,
                                               const uint8_t* label, int label_len) {
  m[n++] = 'N';
  m[n++] = 'o';
  m[n++] = 'D';
  m[n++] = 'S';
  m[n++] = (uint8_t)(round & 0xFF);
  m[n++] = (uint8_t)((round >> 8) & 0xFF);
  for (int i = 0; i < 64; ++i) m[n++] = state[i];
  for (int i = 0; i < label_len; ++i) m[n++] = label[i];
  return n;
}

// Threads 0 and 1 of a block each write one half of CUS(m[0, len)) to out.
__device__ __forceinline__ void cus_half(const uint8_t* m, int len, uint8_t* out) {
  if (threadIdx.x < 2) keccak256(m, len, (int)threadIdx.x, out + 32 * threadIdx.x);
}

}  // namespace sp2
