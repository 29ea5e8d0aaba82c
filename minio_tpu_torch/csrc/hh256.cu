// Keyed HighwayHash (256- and 64-bit finalization) of many rows, for Hopper.
//
// Replaces the TPU kernel minio_tpu/ops/hh_pallas.py::_kernel_nat
// (through _run_nat and hh256_batch), whose packet loop carries the state
// as u32 hi/lo limb planes because the TPU has no 64-bit integers, with
// the remainder packet and finalization left to XLA
// (hh_kernels._remainder_update, hh_pallas._finalize).  Here one thread
// hashes one row start to finish in native uint64_t: the 32-byte packet
// chain, the remainder packet, the permute rounds and the modular
// reduction, and writes the digest.
//
// Bound: the packet chain.  Each row is a chain of n / 32 dependent
// packet updates, so a row cannot finish faster than that chain, however
// few bytes it reads; the byte bound (rows * n over 3.35 TB/s) is far
// below it at the bitrot widths.  With one thread per row, a launch of
// fewer rows than the card has SMs leaves most of it idle: this first
// version accepts that.  It keeps the chain free of memory stalls by
// loading packet p + 1 while it computes packet p.
//
// Rows are unaligned (shard widths are odd multiples of two), so a packet
// is assembled from aligned 8-byte loads joined with shifts; every loaded
// word holds at least one byte of the packet, so no load leaves the row's
// 8-byte-aligned span.  The tail (n % 32 bytes) is read byte by byte.
//
// Input rows: row i = g * R + q lies at in + g * gstride + q * rstride,
// columns dense.  Output: out_bytes (32 or 8) little-endian bytes per row.
// The launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;  // one warp per block: few rows spread over SMs

struct Key {
  uint64_t k[4];
};

struct State {
  uint64_t v0[4], v1[4], mul0[4], mul1[4];
};

__device__ __forceinline__ void zipper(uint64_t v1, uint64_t v0, uint64_t& add1,
                                       uint64_t& add0) {
  add0 = (((v0 & 0xFF000000ull) | (v1 & 0xFF00000000ull)) >> 24) |
         (((v0 & 0xFF0000000000ull) | (v1 & 0xFF000000000000ull)) >> 16) |
         (v0 & 0xFF0000ull) | ((v0 & 0xFF00ull) << 32) |
         ((v1 & 0xFF00000000000000ull) >> 8) | (v0 << 56);
  add1 = (((v1 & 0xFF000000ull) | (v0 & 0xFF00000000ull)) >> 24) | (v1 & 0xFF0000ull) |
         ((v1 & 0xFF0000000000ull) >> 16) | ((v1 & 0xFF00ull) << 24) |
         ((v0 & 0xFF000000000000ull) >> 8) | ((v1 & 0xFFull) << 48) |
         (v0 & 0xFF00000000000000ull);
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

__device__ __forceinline__ uint64_t rot32(uint64_t x) { return (x >> 32) | (x << 32); }

__device__ __forceinline__ void permute_update(State& s) {
  const uint64_t lanes[4] = {rot32(s.v0[2]), rot32(s.v0[3]), rot32(s.v0[0]),
                             rot32(s.v0[1])};
  update(s, lanes);
}

// the 4 little-endian words of the packet at p (p + 32 <= row end)
__device__ __forceinline__ void load_packet(const uint8_t* p, uint64_t (&lanes)[4]) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const int sh = static_cast<int>(addr & 7) * 8;
  const uint64_t* w = reinterpret_cast<const uint64_t*>(addr & ~uintptr_t(7));
  uint64_t x[5];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __ldg(w + i);
  x[4] = sh ? __ldg(w + 4) : 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) lanes[i] = sh ? (x[i] >> sh) | (x[i + 1] << (64 - sh)) : x[i];
}

__device__ void remainder(State& s, const uint8_t* tail, int size) {
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

template <int kOutBytes>
__global__ void __launch_bounds__(kThreads)
hh_kernel(const uint8_t* __restrict__ in, long long gstride, long long rstride, int R,
          long long rows, long long n, Key key, uint8_t* __restrict__ out) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const uint8_t* p = in + (row / R) * gstride + (row % R) * rstride;

  const uint64_t init0[4] = {0xdbe6d5d5fe4cce2full, 0xa4093822299f31d0ull,
                             0x13198a2e03707344ull, 0x243f6a8885a308d3ull};
  const uint64_t init1[4] = {0x3bd39e10cb0ef593ull, 0xc0acf169b5f18a8cull,
                             0xbe5466cf34e90c6cull, 0x452821e638d01377ull};
  State s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s.mul0[i] = init0[i];
    s.mul1[i] = init1[i];
    s.v0[i] = init0[i] ^ key.k[i];
    s.v1[i] = init1[i] ^ rot32(key.k[i]);
  }

  const long long packets = n / 32;
  if (packets > 0) {
    uint64_t cur[4], nxt[4];
    load_packet(p, cur);
    for (long long q = 1; q < packets; ++q) {
      load_packet(p + 32 * q, nxt);
      update(s, cur);
#pragma unroll
      for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
    }
    update(s, cur);
  }
  const int rem = static_cast<int>(n & 31);
  if (rem) remainder(s, p + 32 * packets, rem);

  uint8_t* dst = out + row * kOutBytes;
  if (kOutBytes == 8) {
    for (int i = 0; i < 4; ++i) permute_update(s);
    const uint64_t h = s.v0[0] + s.v1[0] + s.mul0[0] + s.mul1[0];
    for (int b = 0; b < 8; ++b) dst[b] = static_cast<uint8_t>(h >> (8 * b));
  } else {
    for (int i = 0; i < 10; ++i) permute_update(s);
    uint64_t h[4];
    modred(s.v1[1] + s.mul1[1], s.v1[0] + s.mul1[0], s.v0[1] + s.mul0[1],
           s.v0[0] + s.mul0[0], h[0], h[1]);
    modred(s.v1[3] + s.mul1[3], s.v1[2] + s.mul1[2], s.v0[3] + s.mul0[3],
           s.v0[2] + s.mul0[2], h[2], h[3]);
    for (int i = 0; i < 4; ++i)
      for (int b = 0; b < 8; ++b) dst[8 * i + b] = static_cast<uint8_t>(h[i] >> (8 * b));
  }
}

}  // namespace

extern "C" int mt_hh_batch(const void* in, long long gstride, long long rstride, int R,
                           long long rows, long long n, unsigned long long k0,
                           unsigned long long k1, unsigned long long k2,
                           unsigned long long k3, void* out, int out_bytes, void* stream) {
  if (rows <= 0) return 0;
  if (R < 1 || n < 0 || (out_bytes != 32 && out_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const Key key{{k0, k1, k2, k3}};
  const unsigned blocks = static_cast<unsigned>((rows + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  uint8_t* dst = static_cast<uint8_t*>(out);
  if (out_bytes == 32)
    hh_kernel<32><<<blocks, kThreads, 0, s>>>(src, gstride, rstride, R, rows, n, key, dst);
  else
    hh_kernel<8><<<blocks, kThreads, 0, s>>>(src, gstride, rstride, R, rows, n, key, dst);
  return static_cast<int>(cudaGetLastError());
}
