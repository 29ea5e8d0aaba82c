// Keyed HighwayHash state and its update, shared by the kernels that hash
// rows (hh256.cu, rs_fused.cu).  One thread owns one row's state in native
// uint64_t: the 32-byte packet update, the remainder packet, the permute
// rounds and the 256-bit modular reduction of google/highwayhash.

#pragma once

#include <stdint.h>

namespace hh {

struct Key {
  uint64_t k[4];
};

struct State {
  uint64_t v0[4], v1[4], mul0[4], mul1[4];
};

__device__ __forceinline__ uint64_t rot32(uint64_t x) { return (x >> 32) | (x << 32); }

__device__ __forceinline__ void init(State& s, const Key& key) {
  const uint64_t init0[4] = {0xdbe6d5d5fe4cce2full, 0xa4093822299f31d0ull,
                             0x13198a2e03707344ull, 0x243f6a8885a308d3ull};
  const uint64_t init1[4] = {0x3bd39e10cb0ef593ull, 0xc0acf169b5f18a8cull,
                             0xbe5466cf34e90c6cull, 0x452821e638d01377ull};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s.mul0[i] = init0[i];
    s.mul1[i] = init1[i];
    s.v0[i] = init0[i] ^ key.k[i];
    s.v1[i] = init1[i] ^ rot32(key.k[i]);
  }
}

// ZipperMerge of a lane pair: a byte permutation of (v0 || v1), here as
// six byte permutes (PRMT) of its 32-bit words.  Written with 64-bit masks
// and shifts it compiled to some 40 logic instructions, about two thirds
// of an update's instruction count.  Output word w takes input bytes
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

__device__ __forceinline__ void update(State& s, const uint64_t (&lanes)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s.v1[i] += s.mul0[i] + lanes[i];
    s.mul0[i] ^= (s.v1[i] & 0xFFFFFFFFull) * (s.v0[i] >> 32);
    s.v0[i] += s.mul1[i];
    s.mul1[i] ^= (s.v0[i] & 0xFFFFFFFFull) * (s.v1[i] >> 32);
  }
  uint64_t a1, a0;
  zipper(s.v1[1], s.v1[0], a1, a0);
  s.v0[1] += a1;
  s.v0[0] += a0;
  zipper(s.v1[3], s.v1[2], a1, a0);
  s.v0[3] += a1;
  s.v0[2] += a0;
  zipper(s.v0[1], s.v0[0], a1, a0);
  s.v1[1] += a1;
  s.v1[0] += a0;
  zipper(s.v0[3], s.v0[2], a1, a0);
  s.v1[3] += a1;
  s.v1[2] += a0;
}

__device__ __forceinline__ void permute_update(State& s) {
  const uint64_t lanes[4] = {rot32(s.v0[2]), rot32(s.v0[3]), rot32(s.v0[0]),
                             rot32(s.v0[1])};
  update(s, lanes);
}

// the last size (1..31) bytes of a row, read byte by byte
__device__ inline void remainder(State& s, const uint8_t* tail, int size) {
  const int size_mod4 = size & 3;
  const int rem_off = size & ~3;
  const uint64_t sz = static_cast<uint64_t>(size);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
  uint64_t lanes[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint64_t v = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) v |= static_cast<uint64_t>(packet[8 * i + b]) << (8 * b);
    lanes[i] = v;
  }
  update(s, lanes);
}

__device__ __forceinline__ void modred(uint64_t a3u, uint64_t a2, uint64_t a1, uint64_t a0,
                                       uint64_t& m0, uint64_t& m1) {
  const uint64_t a3 = a3u & 0x3FFFFFFFFFFFFFFFull;
  m1 = a1 ^ ((a3 << 1) | (a2 >> 63)) ^ ((a3 << 2) | (a2 >> 62));
  m0 = a0 ^ (a2 << 1) ^ (a2 << 2);
}

// 10 permute rounds and the reduction; 32 little-endian bytes to dst
__device__ __forceinline__ void finish256(State& s, uint8_t* dst) {
  for (int i = 0; i < 10; ++i) permute_update(s);
  uint64_t h[4];
  modred(s.v1[1] + s.mul1[1], s.v1[0] + s.mul1[0], s.v0[1] + s.mul0[1],
         s.v0[0] + s.mul0[0], h[0], h[1]);
  modred(s.v1[3] + s.mul1[3], s.v1[2] + s.mul1[2], s.v0[3] + s.mul0[3],
         s.v0[2] + s.mul0[2], h[2], h[3]);
  for (int i = 0; i < 4; ++i)
    for (int b = 0; b < 8; ++b) dst[8 * i + b] = static_cast<uint8_t>(h[i] >> (8 * b));
}

// 4 permute rounds and the 64-bit sum; 8 little-endian bytes to dst
__device__ __forceinline__ void finish64(State& s, uint8_t* dst) {
  for (int i = 0; i < 4; ++i) permute_update(s);
  const uint64_t h = s.v0[0] + s.v1[0] + s.mul0[0] + s.mul1[0];
  for (int b = 0; b < 8; ++b) dst[b] = static_cast<uint8_t>(h >> (8 * b));
}

}  // namespace hh
