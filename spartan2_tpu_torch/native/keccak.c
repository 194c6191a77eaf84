/* Keccak-256 (original 0x01 padding, rate 1088) — host-side transcript
 * hashing.  Implemented from the Keccak specification; mirrors the pure
 * Python implementation in ../transcript/keccak.py (same function, same
 * test vectors) at C speed: the Fiat-Shamir transcript absorbs
 * multi-KB commitment streams per proof, which dominates host time when
 * hashed in Python.  The JAX package's native/keccak.c, copied.
 *
 * Built at first use with cc into build/native/ at the root of the
 * checkout (native/__init__.py) and loaded through ctypes.
 */

#include <stdint.h>
#include <string.h>

#define ROUNDS 24
#define RATE 136 /* 1088 bits */

static const uint64_t RC[ROUNDS] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int RHO[5][5] = {{0, 36, 3, 41, 18},
                              {1, 44, 10, 45, 2},
                              {62, 6, 43, 15, 61},
                              {28, 55, 25, 21, 56},
                              {27, 20, 39, 8, 14}};

static inline uint64_t rotl(uint64_t v, int n) {
  return n == 0 ? v : (v << n) | (v >> (64 - n));
}

static void keccak_f(uint64_t a[5][5]) {
  uint64_t b[5][5], c[5], d[5];
  for (int rnd = 0; rnd < ROUNDS; rnd++) {
    /* theta */
    for (int x = 0; x < 5; x++)
      c[x] = a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4];
    for (int x = 0; x < 5; x++)
      d[x] = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) a[x][y] ^= d[x];
    /* rho + pi */
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        b[y][(2 * x + 3 * y) % 5] = rotl(a[x][y], RHO[x][y]);
    /* chi */
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y]);
    /* iota */
    a[0][0] ^= RC[rnd];
  }
}

static void absorb_block(uint64_t a[5][5], const uint8_t *block) {
  for (int i = 0; i < RATE / 8; i++) {
    uint64_t lane;
    memcpy(&lane, block + 8 * i, 8); /* little-endian hosts only */
    a[i % 5][i / 5] ^= lane;
  }
  keccak_f(a);
}

void sp2_keccak256(const uint8_t *data, uint64_t len, uint8_t out[32]) {
  uint64_t a[5][5];
  memset(a, 0, sizeof(a));
  uint64_t off = 0;
  while (len - off >= RATE) {
    absorb_block(a, data + off);
    off += RATE;
  }
  /* final partial block with 0x01 ... 0x80 padding (original Keccak) */
  uint8_t block[RATE];
  memset(block, 0, RATE);
  memcpy(block, data + off, len - off);
  block[len - off] ^= 0x01;
  block[RATE - 1] ^= 0x80;
  absorb_block(a, block);
  for (int i = 0; i < 4; i++) {
    uint64_t lane = a[i % 5][i / 5];
    memcpy(out + 8 * i, &lane, 8);
  }
}
