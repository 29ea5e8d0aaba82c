// Keyed HighwayHash state and its update, shared by the kernels that hash
// rows (hh256.cu, rs_fused.cu): the 32-byte packet update, the remainder
// packet, the permute rounds and the 256-bit modular reduction of
// google/highwayhash, in native uint64_t.
//
// A row is hashed by a pair of threads, adjacent lanes of one warp, one
// per half of the state.  The packet update never mixes lanes {0, 1} with
// lanes {2, 3}: its multiply-adds are lane-wise and each ZipperMerge
// reads and writes one lane pair.  So over a row's packets the state is
// two independent half-states, and thread h of the pair holds lanes
// {2h, 2h + 1} of v0, v1, mul0 and mul1 and reads bytes 16h..16h + 15 of
// each packet.  The halves meet only in the permute rounds of the
// finalization, which feed each half the other half's v0; the pair
// exchanges it with __shfl_xor_sync(mask, x, 1).

#pragma once

#include <stdint.h>

namespace hh {

struct Key {
  uint64_t k[4];
};

// lanes {2h, 2h + 1} of the state, h the thread's half
struct HalfState {
  uint64_t v0[2], v1[2], mul0[2], mul1[2];
};

__device__ __forceinline__ uint64_t rot32(uint64_t x) { return (x >> 32) | (x << 32); }

__device__ __forceinline__ void init_half(HalfState& s, const Key& key, int h) {
  const uint64_t init0[4] = {0xdbe6d5d5fe4cce2full, 0xa4093822299f31d0ull,
                             0x13198a2e03707344ull, 0x243f6a8885a308d3ull};
  const uint64_t init1[4] = {0x3bd39e10cb0ef593ull, 0xc0acf169b5f18a8cull,
                             0xbe5466cf34e90c6cull, 0x452821e638d01377ull};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int lane = 2 * h + i;
    s.mul0[i] = init0[lane];
    s.mul1[i] = init1[lane];
    s.v0[i] = init0[lane] ^ key.k[lane];
    s.v1[i] = init1[lane] ^ rot32(key.k[lane]);
  }
}

// ZipperMerge of a lane pair: a byte permutation of (v0 || v1), here as
// six byte permutes (PRMT) of its 32-bit words.  Output word w takes input
// bytes
//   add0 lo: 3 12 2 5   add0 hi: 14 1 15 0
//   add1 lo: 11 4 10 13 add1 hi: 9 6 8 7   (bytes 0-7 v0, 8-15 v1)
__device__ __forceinline__ void zipper(uint64_t v1, uint64_t v0, uint64_t& add1,
                                       uint64_t& add0) {
  const uint32_t a0 = static_cast<uint32_t>(v0), a1 = static_cast<uint32_t>(v0 >> 32);
  const uint32_t a2 = static_cast<uint32_t>(v1), a3 = static_cast<uint32_t>(v1 >> 32);
  const uint32_t w0 = __byte_perm(__byte_perm(a0, a1, 0x5203), a3, 0x3240);
  const uint32_t w1 = __byte_perm(a0, a3, 0x0716);
  const uint32_t w2 = __byte_perm(__byte_perm(a2, a1, 0x0243), a3, 0x5210);
  const uint32_t w3 = __byte_perm(a2, a1, 0x7061);
  add0 = (static_cast<uint64_t>(w1) << 32) | w0;
  add1 = (static_cast<uint64_t>(w3) << 32) | w2;
}

// one packet update of a half-state: p0, p1 are packet words 2h, 2h + 1
__device__ __forceinline__ void update_half(HalfState& s, uint64_t p0, uint64_t p1) {
  const uint64_t p[2] = {p0, p1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s.v1[i] += s.mul0[i] + p[i];
    s.mul0[i] ^= (s.v1[i] & 0xFFFFFFFFull) * (s.v0[i] >> 32);
    s.v0[i] += s.mul1[i];
    s.mul1[i] ^= (s.v0[i] & 0xFFFFFFFFull) * (s.v1[i] >> 32);
  }
  uint64_t a1, a0;
  zipper(s.v1[1], s.v1[0], a1, a0);
  s.v0[1] += a1;
  s.v0[0] += a0;
  zipper(s.v0[1], s.v0[0], a1, a0);
  s.v1[1] += a1;
  s.v1[0] += a0;
}

// the last size (1..31) bytes of a row, read byte by byte.  Both halves
// assemble the whole remainder packet (its byte placement depends on the
// size) and take their 16 bytes of it.
__device__ inline void remainder_half(HalfState& s, int h, const uint8_t* tail, int size) {
  const int size_mod4 = size & 3;
  const int rem_off = size & ~3;
  const uint64_t sz = static_cast<uint64_t>(size);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s.v0[i] += (sz << 32) + sz;
    const uint32_t h0 = static_cast<uint32_t>(s.v1[i]);
    const uint32_t h1 = static_cast<uint32_t>(s.v1[i] >> 32);
    const uint32_t r0 = (h0 << size) | (h0 >> (32 - size));
    const uint32_t r1 = (h1 << size) | (h1 >> (32 - size));
    s.v1[i] = (static_cast<uint64_t>(r1) << 32) | r0;
  }
  uint8_t packet[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) packet[i] = 0;
  for (int i = 0; i < rem_off; ++i) packet[i] = tail[i];
  if (size & 16) {
    for (int i = 0; i < 4; ++i) packet[28 + i] = tail[rem_off + i + size_mod4 - 4];
  } else if (size_mod4) {
    packet[16] = tail[rem_off];
    packet[17] = tail[rem_off + (size_mod4 >> 1)];
    packet[18] = tail[rem_off + size_mod4 - 1];
  }
  uint64_t lanes[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint64_t v = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b)
      v |= static_cast<uint64_t>(packet[16 * h + 8 * i + b]) << (8 * b);
    lanes[i] = v;
  }
  update_half(s, lanes[0], lanes[1]);
}

// a permute round: the packet is rot32 of the other half's v0, lanes
// {2, 3, 0, 1}.  Every lane of `mask` must call it.
__device__ __forceinline__ void permute_update_half(HalfState& s, unsigned mask) {
  const uint64_t q0 = __shfl_xor_sync(mask, s.v0[0], 1);
  const uint64_t q1 = __shfl_xor_sync(mask, s.v0[1], 1);
  update_half(s, rot32(q0), rot32(q1));
}

__device__ __forceinline__ void modred(uint64_t a3u, uint64_t a2, uint64_t a1, uint64_t a0,
                                       uint64_t& m0, uint64_t& m1) {
  const uint64_t a3 = a3u & 0x3FFFFFFFFFFFFFFFull;
  m1 = a1 ^ ((a3 << 1) | (a2 >> 63)) ^ ((a3 << 2) | (a2 >> 62));
  m0 = a0 ^ (a2 << 1) ^ (a2 << 2);
}

__device__ __forceinline__ void store_le(uint8_t* dst, uint64_t x) {
#pragma unroll
  for (int b = 0; b < 8; ++b) dst[b] = static_cast<uint8_t>(x >> (8 * b));
}

// 10 permute rounds, then each half reduces its lane pair: digest bytes
// 16h..16h + 15 to dst (the row's 32-byte digest); write = false runs the
// rounds for the partner only.  Every lane of `mask` must call it.
__device__ __forceinline__ void finish256_half(HalfState& s, int h, uint8_t* dst,
                                               bool write, unsigned mask) {
  for (int i = 0; i < 10; ++i) permute_update_half(s, mask);
  uint64_t m0, m1;
  modred(s.v1[1] + s.mul1[1], s.v1[0] + s.mul1[0], s.v0[1] + s.mul0[1],
         s.v0[0] + s.mul0[0], m0, m1);
  if (write) {
    store_le(dst + 16 * h, m0);
    store_le(dst + 16 * h + 8, m1);
  }
}

// 4 permute rounds and the 64-bit sum of lane 0: 8 bytes to dst from
// half 0.  Every lane of `mask` must call it.
__device__ __forceinline__ void finish64_half(HalfState& s, int h, uint8_t* dst,
                                              bool write, unsigned mask) {
  for (int i = 0; i < 4; ++i) permute_update_half(s, mask);
  if (write && h == 0) store_le(dst, s.v0[0] + s.v1[0] + s.mul0[0] + s.mul1[0]);
}

}  // namespace hh
