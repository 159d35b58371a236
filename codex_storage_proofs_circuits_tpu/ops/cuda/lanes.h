/* Per-lane hash arithmetic for the CUDA kernels (kernels.cu).
 *
 * One lane = one independent hash (a cell sponge or a tree compression).
 * Under nvcc every lane runs in its own thread with its whole state in
 * registers: BN254 Fr as 4 x 64-bit limbs in Montgomery form, a Goldilocks
 * felt as one uint64_t.  The same code also compiles as plain C++ on the
 * host, where kernels.cu loops over the lanes; the CPU tests run that build
 * against the jnp path and the oracle.
 *
 * Arrays cross the kernel boundary in the jnp pipeline's layout: planes of
 * 16-bit limbs held in uint32, batch (lane) on the minor axis, so element
 * (i, lane) of a (K, B) plane stack is p[i * B + lane].  BN254 felts are 16
 * limbs, Goldilocks felts 4.  The arithmetic follows the C host library
 * (native/cspc_native.c, native/cspc_gl.c), which is checked against the
 * oracle.
 */
#pragma once
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define LANE static __device__ __forceinline__
#define CSPC_CONST static __constant__
#else
#define LANE static inline
#endif
#include "poseidon2_constants.h"
#include "gl_constants.h"

typedef unsigned __int128 u128;

/* ------------------------------------------------------------------ */
/* Limb-plane I/O.                                                     */

/* 4 consecutive 16-bit limb planes -> one uint64_t */
LANE uint64_t load64(const uint32_t *p, int64_t B, int64_t b) {
  return (uint64_t)p[b] | (uint64_t)p[B + b] << 16 | (uint64_t)p[2 * B + b] << 32 |
         (uint64_t)p[3 * B + b] << 48;
}

LANE void store64(uint32_t *p, int64_t B, int64_t b, uint64_t v) {
  p[b] = (uint32_t)(v & 0xffff);
  p[B + b] = (uint32_t)((v >> 16) & 0xffff);
  p[2 * B + b] = (uint32_t)((v >> 32) & 0xffff);
  p[3 * B + b] = (uint32_t)(v >> 48);
}

/* BN254 felt: 16 limb planes starting at p */
LANE void fr_load(uint64_t r[4], const uint32_t *p, int64_t B, int64_t b) {
  for (int i = 0; i < 4; i++) r[i] = load64(p + 4 * i * B, B, b);
}

LANE void fr_store(uint32_t *p, int64_t B, int64_t b, const uint64_t a[4]) {
  for (int i = 0; i < 4; i++) store64(p + 4 * i * B, B, b, a[i]);
}

/* ------------------------------------------------------------------ */
/* BN254 Fr, Montgomery form (R = 2^256), inputs and outputs < P.      */

LANE int fr_geq_p(const uint64_t a[4]) {
  for (int i = 3; i >= 0; i--) {
    if (a[i] > FR_P[i]) return 1;
    if (a[i] < FR_P[i]) return 0;
  }
  return 1;
}

LANE void fr_sub_p(uint64_t a[4]) {
  uint64_t brw = 0;
  for (int i = 0; i < 4; i++) {
    u128 d = (u128)a[i] - FR_P[i] - brw;
    a[i] = (uint64_t)d;
    brw = (uint64_t)(d >> 64) & 1;
  }
}

LANE void fr_add(uint64_t r[4], const uint64_t a[4], const uint64_t b[4]) {
  u128 c = 0;
  for (int i = 0; i < 4; i++) {
    c += (u128)a[i] + b[i];
    r[i] = (uint64_t)c;
    c >>= 64;
  }
  if (fr_geq_p(r)) fr_sub_p(r);
}

/* CIOS Montgomery product r = a*b/R mod P (r may alias a or b) */
LANE void fr_mul(uint64_t r[4], const uint64_t a[4], const uint64_t b[4]) {
  uint64_t t[5] = {0, 0, 0, 0, 0};
  for (int i = 0; i < 4; i++) {
    u128 c = 0;
    for (int j = 0; j < 4; j++) {
      c += (u128)t[j] + (u128)a[j] * b[i];
      t[j] = (uint64_t)c;
      c >>= 64;
    }
    uint64_t t4 = t[4] + (uint64_t)c;
    uint64_t m = t[0] * FR_P_INV_NEG;
    c = ((u128)t[0] + (u128)m * FR_P[0]) >> 64;
    for (int j = 1; j < 4; j++) {
      c += (u128)t[j] + (u128)m * FR_P[j];
      t[j - 1] = (uint64_t)c;
      c >>= 64;
    }
    c += t4;
    t[3] = (uint64_t)c;
    t[4] = (uint64_t)(c >> 64);
  }
  for (int i = 0; i < 4; i++) r[i] = t[i];
  if (t[4] || fr_geq_p(r)) fr_sub_p(r);
}

LANE void fr_sbox(uint64_t x[4]) {
  uint64_t x2[4], x4[4];
  fr_mul(x2, x, x);
  fr_mul(x4, x2, x2);
  fr_mul(x, x4, x);
}

/* Poseidon2 t=3: initial linear layer, 4 external, 56 internal, 4 external
 * rounds (circuit/poseidon2/poseidon2_perm.circom:163-198). */
LANE void p2_linear(uint64_t s[3][4]) {
  uint64_t sum[4];
  fr_add(sum, s[0], s[1]);
  fr_add(sum, sum, s[2]);
  for (int l = 0; l < 3; l++) fr_add(s[l], s[l], sum);
}

LANE void p2_external(uint64_t s[3][4], int k) {
  for (int l = 0; l < 3; l++) {
    fr_add(s[l], s[l], P2_EXT_RC[k][l]);
    fr_sbox(s[l]);
  }
  p2_linear(s);
}

/* internal matrix [[2,1,1],[1,2,1],[1,1,3]] */
LANE void p2_internal(uint64_t s[3][4], int k) {
  uint64_t sum[4], z2[4];
  fr_add(s[0], s[0], P2_INT_RC[k]);
  fr_sbox(s[0]);
  fr_add(sum, s[0], s[1]);
  fr_add(sum, sum, s[2]);
  fr_add(z2, s[2], s[2]);
  fr_add(s[0], s[0], sum);
  fr_add(s[1], s[1], sum);
  fr_add(s[2], z2, sum);
}

LANE void p2_permute(uint64_t s[3][4]) {
  p2_linear(s);
  for (int k = 0; k < 4; k++) p2_external(s, k);
  for (int k = 0; k < 56; k++) p2_internal(s, k);
  for (int k = 4; k < 8; k++) p2_external(s, k);
}

/* (3, 16, B) Montgomery states -> permuted states */
LANE void bn_permute_lane(const uint32_t *in, uint32_t *out, int64_t B, int64_t b) {
  uint64_t s[3][4];
  for (int l = 0; l < 3; l++) fr_load(s[l], in + 16 * l * B, B, b);
  p2_permute(s);
  for (int l = 0; l < 3; l++) fr_store(out + 16 * l * B, B, b, s[l]);
}

/* (nf, 16, B) canonical felts -> (16, B) Montgomery rate-2 sponge hash with
 * felt-level 10* padding and IV 2^64 + 0x0302 (poseidon2_sponge.circom) */
LANE void bn_sponge_lane(const uint32_t *felts, int64_t nf, uint32_t *out, int64_t B,
                         int64_t b) {
  uint64_t s[3][4];
  for (int i = 0; i < 4; i++) {
    s[0][i] = 0;
    s[1][i] = 0;
    s[2][i] = P2_SPONGE2_IV[i];
  }
  int64_t total = nf + 1 + ((nf + 1) & 1);
  for (int64_t k = 0; k < total; k += 2) {
    for (int half = 0; half < 2; half++) {
      int64_t f = k + half;
      uint64_t a[4] = {0, 0, 0, 0};
      if (f < nf) {
        fr_load(a, felts + 16 * f * B, B, b);
        fr_mul(a, a, FR_R2_MONT);
      } else if (f == nf) {
        for (int i = 0; i < 4; i++) a[i] = P2_ONE_MONT[i];
      }
      fr_add(s[half], s[half], a);
    }
    p2_permute(s);
  }
  fr_store(out, B, b, s[0]);
}

/* (16, B) -> (16, B): to Montgomery form (to=1) or back (to=0) */
LANE void bn_mont_lane(const uint32_t *in, uint32_t *out, int64_t B, int64_t b, int to) {
  const uint64_t one[4] = {1, 0, 0, 0};
  uint64_t a[4];
  fr_load(a, in, B, b);
  fr_mul(a, a, to ? FR_R2_MONT : one);
  fr_store(out, B, b, a);
}

/* ------------------------------------------------------------------ */
/* Goldilocks, p = 2^64 - 2^32 + 1.                                    */

LANE uint64_t gl_reduce128(u128 x) {
  uint64_t lo = (uint64_t)x;
  uint64_t hi = (uint64_t)(x >> 64);
  uint64_t hi_lo = hi & 0xffffffffULL;
  uint64_t hi_hi = hi >> 32;
  uint64_t t = lo - hi_hi;
  if (lo < hi_hi) t -= 0xffffffffULL;
  uint64_t r = t + hi_lo * 0xffffffffULL;
  if (r < t) r += 0xffffffffULL;
  if (r >= GL_P) r -= GL_P;
  return r;
}

LANE uint64_t gl_mul(uint64_t a, uint64_t b) { return gl_reduce128((u128)a * b); }

LANE uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t r = a + b;
  if (r < a) r += 0xffffffffULL;
  if (r >= GL_P) r -= GL_P;
  return r;
}

LANE uint64_t gl_sbox7(uint64_t x) {
  uint64_t x2 = gl_mul(x, x);
  uint64_t x4 = gl_mul(x2, x2);
  return gl_mul(gl_mul(x4, x2), x);
}

/* Poseidon2-GL t=12 */
LANE void gl_m4(uint64_t x[4]) {
  uint64_t t0 = gl_add(x[0], x[1]);
  uint64_t t1 = gl_add(x[2], x[3]);
  uint64_t t2 = gl_add(gl_add(x[1], x[1]), t1);
  uint64_t t3 = gl_add(gl_add(x[3], x[3]), t0);
  uint64_t t4 = gl_add(gl_add(gl_add(t1, t1), gl_add(t1, t1)), t3);
  uint64_t t5 = gl_add(gl_add(gl_add(t0, t0), gl_add(t0, t0)), t2);
  x[0] = gl_add(t3, t5);
  x[1] = t5;
  x[2] = gl_add(t2, t4);
  x[3] = t4;
}

LANE void gl_external_linear(uint64_t s[GL_T]) {
  uint64_t sum[4];
  for (int j = 0; j < 4; j++) sum[j] = gl_add(gl_add(s[j], s[4 + j]), s[8 + j]);
  for (int k = 0; k < 3; k++) {
    uint64_t blk[4];
    for (int j = 0; j < 4; j++) blk[j] = gl_add(s[4 * k + j], sum[j]);
    gl_m4(blk);
    for (int j = 0; j < 4; j++) s[4 * k + j] = blk[j];
  }
}

LANE void gl_p2_full_round(uint64_t s[GL_T], int r) {
  for (int i = 0; i < GL_T; i++) s[i] = gl_sbox7(gl_add(s[i], GL_EXT_RC[r][i]));
  gl_external_linear(s);
}

LANE void gl_p2_permute(uint64_t s[GL_T]) {
  gl_external_linear(s);
  for (int r = 0; r < GL_RF / 2; r++) gl_p2_full_round(s, r);
  for (int r = 0; r < GL_RP; r++) {
    s[0] = gl_sbox7(gl_add(s[0], GL_INT_RC[r]));
    uint64_t tot = 0;
    for (int i = 0; i < GL_T; i++) tot = gl_add(tot, s[i]);
    for (int i = 0; i < GL_T; i++) s[i] = gl_add(tot, gl_mul(GL_DIAG_M1[i], s[i]));
  }
  for (int r = GL_RF / 2; r < GL_RF; r++) gl_p2_full_round(s, r);
}

/* Monolith-64 t=12 */
LANE uint64_t gl_bar64(uint64_t x) {
  /* bar(b) = rotl1(b ^ (rotl1(~b) & rotl2(b) & rotl3(b))) on each byte,
   * done on all 8 bytes at once with in-byte rotations */
  const uint64_t lo1 = 0x0101010101010101ULL;
  uint64_t nx = ~x;
  uint64_t r1 = ((nx << 1) & ~lo1) | ((nx >> 7) & lo1);
  uint64_t r2 = ((x << 2) & ~(lo1 * 3)) | ((x >> 6) & (lo1 * 3));
  uint64_t r3 = ((x << 3) & ~(lo1 * 7)) | ((x >> 5) & (lo1 * 7));
  uint64_t y = x ^ (r1 & r2 & r3);
  uint64_t out = ((y << 1) & ~lo1) | ((y >> 7) & lo1);
  return out >= GL_P ? out - GL_P : out;
}

LANE void gl_concrete(uint64_t s[GL_T]) {
  uint64_t out[GL_T];
  for (int r = 0; r < GL_T; r++) {
    u128 acc = 0;
    for (int c = 0; c < GL_T; c++) acc += (u128)GL_MONO_CONCRETE[r][c] * s[c];
    out[r] = gl_reduce128(acc);
  }
  for (int i = 0; i < GL_T; i++) s[i] = out[i];
}

LANE void gl_mono_permute(uint64_t s[GL_T]) {
  gl_concrete(s);
  for (int r = 0; r < GL_MONO_ROUNDS; r++) {
    for (int i = 0; i < GL_MONO_BARS; i++) s[i] = gl_bar64(s[i]);
    uint64_t prev = s[0];
    for (int i = 1; i < GL_T; i++) {
      uint64_t cur = s[i];
      s[i] = gl_add(cur, gl_mul(prev, prev));
      prev = cur;
    }
    gl_concrete(s);
    for (int i = 0; i < GL_T; i++) s[i] = gl_add(s[i], GL_MONO_RC[r][i]);
  }
}

LANE void gl_permute(uint64_t s[GL_T], int monolith) {
  if (monolith)
    gl_mono_permute(s);
  else
    gl_p2_permute(s);
}

/* (nf, 4, B) felts -> (4, 4, B) digests: rate-8 sponge, 10* felt padding */
LANE void gl_sponge_lane(const uint32_t *felts, int64_t nf, uint32_t *out, int64_t B,
                         int64_t b, int monolith) {
  uint64_t s[GL_T];
  for (int i = 0; i < GL_T; i++) s[i] = 0;
  s[GL_T - 1] = GL_SPONGE_IV;
  int64_t total = nf + 1;
  total += (GL_RATE - total % GL_RATE) % GL_RATE;
  for (int64_t k = 0; k < total; k += GL_RATE) {
    for (int j = 0; j < GL_RATE; j++) {
      int64_t f = k + j;
      uint64_t v = f < nf ? load64(felts + 4 * f * B, B, b) : (f == nf ? 1 : 0);
      s[j] = gl_add(s[j], v);
    }
    gl_permute(s, monolith);
  }
  for (int j = 0; j < 4; j++) store64(out + 4 * j * B, B, b, s[j]);
}

/* keyed 2-to-1 digest compression: (4, 4, B) x (4, 4, B) -> (4, 4, B) */
LANE void gl_compress_lane(const uint32_t *x, const uint32_t *y, uint32_t *out, int64_t B,
                           int64_t b, uint64_t key, int monolith) {
  uint64_t s[GL_T];
  for (int j = 0; j < 4; j++) {
    s[j] = load64(x + 4 * j * B, B, b);
    s[4 + j] = load64(y + 4 * j * B, B, b);
  }
  s[8] = key;
  s[9] = s[10] = s[11] = 0;
  gl_permute(s, monolith);
  for (int j = 0; j < 4; j++) store64(out + 4 * j * B, B, b, s[j]);
}
