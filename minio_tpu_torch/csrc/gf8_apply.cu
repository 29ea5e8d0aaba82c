// GF(2^8) matrix apply for Hopper: out[b] = M (GF) @ in[b].
//
// Replaces the TPU kernel minio_tpu/ops/rs_pallas.py::_kernel (through
// _gf2_apply_bm and apply_matrix), which unpacks bytes into bit planes
// and multiplies them on the 128x128 int8 MXU.  That design was sized to
// the MXU; this one computes the same function byte by byte.
//
// Bound: bytes.  The work is k + r bytes moved per output column and a
// few table lookups per byte, so device memory (3.35 TB/s on an H100
// SXM) is the floor: (k + r) * n * B bytes.
//
// Design (first, simple version):
//   * the GF log and exp tables and the coefficient logs of one group of
//     output rows live in shared memory;
//   * each thread owns 16 consecutive byte columns of one stripe; it loads
//     every input row as one 16-byte vector when the row address allows,
//     and byte by byte at the ragged edge and for unaligned rows (rows of
//     an odd-width shard start anywhere), so it never reads past a row;
//   * products are exp[log x + log c]: log[0] and the log of a zero
//     coefficient are the sentinel 510, and exp[i] = 0 for i >= 510, so
//     zero needs no branch;
//   * outputs are produced RT rows per pass, so any r and k up to 256 run
//     through the same kernel (larger r re-reads the inputs per pass).
//
// Strides are in bytes and free on the batch and row axes; the column
// axis is dense.  The launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 16;      // byte columns per thread
constexpr int kRT = 4;         // output rows per pass
constexpr int kThreads = 256;
constexpr int kMaxK = 256;
constexpr int kExpLen = 1024;  // exp table, zero from index 510 on

struct Geometry {
  long long in_bstride, in_rstride, out_bstride, out_rstride, n;
  int B, k, r;
};

__device__ __forceinline__ void load16(const uint8_t* src, int w,
                                       uint8_t (&x)[kCols]) {
  if (w == kCols && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    uint4 v = *reinterpret_cast<const uint4*>(src);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int t = 0; t < kCols; ++t) x[t] = (words[t >> 2] >> (8 * (t & 3))) & 0xFF;
  } else {
#pragma unroll
    for (int t = 0; t < kCols; ++t) x[t] = t < w ? src[t] : 0;
  }
}

__device__ __forceinline__ void store16(uint8_t* dst, int w,
                                        const uint8_t (&y)[kCols]) {
  if (w == kCols && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    uint32_t words[4] = {0, 0, 0, 0};
#pragma unroll
    for (int t = 0; t < kCols; ++t) words[t >> 2] |= uint32_t(y[t]) << (8 * (t & 3));
    *reinterpret_cast<uint4*>(dst) = make_uint4(words[0], words[1], words[2], words[3]);
  } else {
#pragma unroll
    for (int t = 0; t < kCols; ++t)
      if (t < w) dst[t] = y[t];
  }
}

__global__ void __launch_bounds__(kThreads)
gf8_apply_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 const uint16_t* __restrict__ coef_log,  // (r, k)
                 const uint16_t* __restrict__ log_tab,   // (256,)
                 const uint8_t* __restrict__ exp_tab,    // (1024,)
                 Geometry g) {
  __shared__ uint8_t s_exp[kExpLen];
  __shared__ uint16_t s_log[256];
  __shared__ uint16_t s_lc[kRT * kMaxK];

  for (int i = threadIdx.x; i < kExpLen; i += blockDim.x) s_exp[i] = exp_tab[i];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_log[i] = log_tab[i];

  const long long c0 = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kCols;
  const bool active = c0 < g.n;
  const long long rest = g.n - c0;
  const int w = !active ? 0 : rest < kCols ? static_cast<int>(rest) : kCols;

  for (int b = blockIdx.y; b < g.B; b += gridDim.y) {
    const uint8_t* src_b = in + b * g.in_bstride + c0;
    uint8_t* dst_b = out + b * g.out_bstride + c0;
    for (int og = 0; og < g.r; og += kRT) {
      __syncthreads();  // previous pass done with s_lc
      for (int i = threadIdx.x; i < kRT * g.k; i += blockDim.x) {
        const int o = og + i / g.k;
        s_lc[i] = o < g.r ? coef_log[o * g.k + i % g.k] : 510;
      }
      __syncthreads();
      if (!active) continue;
      uint8_t acc[kRT][kCols];
#pragma unroll
      for (int o = 0; o < kRT; ++o)
#pragma unroll
        for (int t = 0; t < kCols; ++t) acc[o][t] = 0;
      for (int j = 0; j < g.k; ++j) {
        uint8_t x[kCols];
        load16(src_b + j * g.in_rstride, w, x);
        uint16_t lx[kCols];
#pragma unroll
        for (int t = 0; t < kCols; ++t) lx[t] = s_log[x[t]];
#pragma unroll
        for (int o = 0; o < kRT; ++o) {
          const uint16_t lc = s_lc[o * g.k + j];
#pragma unroll
          for (int t = 0; t < kCols; ++t) acc[o][t] ^= s_exp[lx[t] + lc];
        }
      }
#pragma unroll
      for (int o = 0; o < kRT; ++o)
        if (og + o < g.r) store16(dst_b + (og + o) * g.out_rstride, w, acc[o]);
    }
  }
}

}  // namespace

extern "C" int mt_gf8_apply(const void* in, long long in_bstride, long long in_rstride,
                            void* out, long long out_bstride, long long out_rstride,
                            const void* coef_log, const void* log_tab, const void* exp_tab,
                            int B, int k, int r, long long n, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (k < 1 || k > kMaxK || r < 1 || r > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  Geometry g{in_bstride, in_rstride, out_bstride, out_rstride, n, B, k, r};
  const long long groups = (n + kCols - 1) / kCols;
  dim3 grid(static_cast<unsigned>((groups + kThreads - 1) / kThreads),
            static_cast<unsigned>(B < 65535 ? B : 65535));
  gf8_apply_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const uint16_t*>(coef_log), static_cast<const uint16_t*>(log_tab),
      static_cast<const uint8_t*>(exp_tab), g);
  return static_cast<int>(cudaGetLastError());
}
