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
// The state and its update live in hh256_core.cuh, shared with rs_fused.cu.
//
// Input rows: row i = g * R + q lies at in + g * gstride + q * rstride,
// columns dense.  Output: out_bytes (32 or 8) little-endian bytes per row.
// The launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "hh256_core.cuh"

namespace {

constexpr int kThreads = 32;  // one warp per block: few rows spread over SMs

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

template <int kOutBytes>
__global__ void __launch_bounds__(kThreads)
hh_kernel(const uint8_t* __restrict__ in, long long gstride, long long rstride, int R,
          long long rows, long long n, hh::Key key, uint8_t* __restrict__ out) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const uint8_t* p = in + (row / R) * gstride + (row % R) * rstride;

  hh::State s;
  hh::init(s, key);

  const long long packets = n / 32;
  if (packets > 0) {
    uint64_t cur[4], nxt[4];
    load_packet(p, cur);
    for (long long q = 1; q < packets; ++q) {
      load_packet(p + 32 * q, nxt);
      hh::update(s, cur);
#pragma unroll
      for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
    }
    hh::update(s, cur);
  }
  const int rem = static_cast<int>(n & 31);
  if (rem) hh::remainder(s, p + 32 * packets, rem);

  uint8_t* dst = out + row * kOutBytes;
  if (kOutBytes == 8)
    hh::finish64(s, dst);
  else
    hh::finish256(s, dst);
}

}  // namespace

extern "C" int mt_hh_batch(const void* in, long long gstride, long long rstride, int R,
                           long long rows, long long n, unsigned long long k0,
                           unsigned long long k1, unsigned long long k2,
                           unsigned long long k3, void* out, int out_bytes, void* stream) {
  if (rows <= 0) return 0;
  if (R < 1 || n < 0 || (out_bytes != 32 && out_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const hh::Key key{{k0, k1, k2, k3}};
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
