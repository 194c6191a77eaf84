// Keccak-256 and the Fiat-Shamir squeeze as device functions (kernel T),
// inlined into csrc/transcript.cu and the round finish (csrc/round_finish.cu).
//
// Replaces the JAX package's device Keccak and transcript
// (spartan2_tpu/transcript/device.py: keccak_f1600_dev :67, keccak256_dev
// :133, compute_updated_state_dev :173, DeviceTranscript.squeeze_bytes
// :235-252).  The TPU has no 64-bit integers, so JAX kept each lane as a
// pair of uint32 planes; here a lane is a native uint64_t and one warp
// runs the permutation: lane l < 25 holds the state lane A[x][y], l = x +
// 5 y (tiny_sha3's order); lanes 25-31 carry values nobody reads.  Theta's
// column parities, its neighbour columns, the pi move and chi's row
// neighbours are shuffles (9 of 64 bits a round, 4 deep), rho is each
// lane's own rotation and iota lane 0's.  Padding is the original
// Keccak's 0x01 .. 0x80 (0x81 when one byte is left), rate 136 bytes.
//
// Bound: a permutation is 24 dependent rounds of a few shuffles and logic
// operations; a squeeze (two hashes of 2 blocks each for a sum-check
// round) is latency: the two hashes run in two warps side by side.
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

// rho's rotation of lane x + 5 y (0 for the idle lanes)
__constant__ uint8_t KECCAK_RHO[32] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,
                                       10, 43, 25, 39, 41, 45, 15, 21, 8,  18, 2,
                                       61, 56, 14, 0,  0,  0,  0,  0,  0,  0};

constexpr int KECCAK_RATE = 136;
constexpr int KECCAK_RATE_LANES = KECCAK_RATE / 8;
// DOM_SEP_TAG || round (u16 LE) || state (64 bytes), before the label
constexpr int SQUEEZE_SUFFIX = 4 + 2 + 64;

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) {  // 0 <= n < 64
  return n ? (x << n) | (x >> (64 - n)) : x;
}

__device__ __forceinline__ uint64_t shfl64(uint64_t v, int src) {
  return __shfl_sync(0xFFFFFFFFu, (unsigned long long)v, src);
}

// Keccak-f[1600] of the state spread over the calling warp (all 32 lanes
// call it; lane l < 25 holds A[l % 5][l / 5]) -> the lane's new value.
__device__ __forceinline__ uint64_t keccak_f1600_warp(uint64_t a) {
  const int l = threadIdx.x & 31;
  const int x = l % 5, y = (l / 5) % 5;
  const int rho = KECCAK_RHO[l];
  // pi: lane (x, y) takes the rotated lane (x + 3 y, x); theta's and chi's
  // neighbours by column and by row
  const int pi = l < 25 ? (x + 3 * y) % 5 + 5 * x : l - 25;
  const int col1 = x + 5 * ((y + 1) % 5), col2 = x + 5 * ((y + 2) % 5);
  const int col3 = x + 5 * ((y + 3) % 5), col4 = x + 5 * ((y + 4) % 5);
  const int left = (x + 4) % 5, right = (x + 1) % 5;
  const int row1 = (x + 1) % 5 + 5 * y, row2 = (x + 2) % 5 + 5 * y;
  for (int rnd = 0; rnd < 24; ++rnd) {
    // theta: every lane forms its column's parity, lanes 0-4 hold C[0..4]
    const uint64_t c = a ^ shfl64(a, col1) ^ shfl64(a, col2) ^ shfl64(a, col3) ^
                       shfl64(a, col4);
    a ^= shfl64(c, left) ^ rotl64(shfl64(c, right), 1);
    // rho and pi
    const uint64_t b = shfl64(rotl64(a, rho), pi);
    // chi
    a = b ^ (~shfl64(b, row1) & shfl64(b, row2));
    // iota
    if (l == 0) a ^= KECCAK_RC[rnd];
  }
  return a;
}

// Keccak-256 by one warp of the message whose 64-bit little-endian words
// word(i) (bytes 8 i .. 8 i + 7, zero at and past len) are given, followed
// by the byte ``extra`` (none when extra < 0).  -> lane i < 4 returns the
// digest's bytes 8 i .. 8 i + 7 as a little-endian word.
template <class Word>
__device__ __forceinline__ uint64_t keccak256_warp(Word word, int len, int extra) {
  const int l = threadIdx.x & 31;
  const int total = len + (extra >= 0 ? 1 : 0);
  uint64_t st = 0;
  for (int off = 0;; off += KECCAK_RATE) {
    const bool last = total - off < KECCAK_RATE;
    if (l < KECCAK_RATE_LANES) {
      const int i = off / 8 + l;
      uint64_t w = word(i);
      if (extra >= 0 && (len >> 3) == i) w |= (uint64_t)(extra & 0xFF) << (8 * (len & 7));
      if (last && (total >> 3) == i) w ^= 1ULL << (8 * (total & 7));  // first padding byte
      if (last && l == KECCAK_RATE_LANES - 1) w ^= 0x80ULL << 56;     // last one
      st ^= w;
    }
    st = keccak_f1600_warp(st);
    if (last) break;
  }
  return st;
}

// Bytes 8 i .. 8 i + 7 of m[0, len) as a little-endian word, zero past len.
__device__ __forceinline__ uint64_t message_word(const uint8_t* m, int len, int i) {
  uint64_t w = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const int k = 8 * i + b;
    if (k < len) w |= (uint64_t)m[k] << (8 * b);
  }
  return w;
}

// Byte k of the squeeze suffix DOM_SEP_TAG || round (u16 LE) || state ||
// label (transcript.py _squeeze), k < SQUEEZE_SUFFIX + label length.
__device__ __forceinline__ uint8_t squeeze_suffix_byte(int k, int round, const uint8_t* state,
                                                      const uint8_t* label) {
  if (k < 4) return "NoDS"[k];
  if (k < 6) return (uint8_t)((round >> (8 * (k - 4))) & 0xFF);
  if (k < SQUEEZE_SUFFIX) return state[k - 6];
  return label[k - SQUEEZE_SUFFIX];
}

// CUS(m) = keccak256(m || 0x00) || keccak256(m || 0x01)
// (transcript.py _compute_updated_state): warps 0 and 1 of the block each
// hash one half and write its 4 words to out[4 w ..]; other warps skip.
template <class Word>
__device__ __forceinline__ void cus_warps(Word word, int len, uint64_t* out) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (w < 2) {
    const uint64_t h = keccak256_warp(word, len, w);
    if (l < 4) out[4 * w + l] = h;
  }
}

}  // namespace sp2
