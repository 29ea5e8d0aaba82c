// GF(2^8) matrix apply for Hopper: out[b] = M (GF) @ in[b] (Kernel A).
//
// Replaces the TPU kernel minio_tpu/ops/rs_pallas.py::_kernel (through
// _gf2_apply_bm and apply_matrix), which unpacks bytes into bit planes
// and multiplies them on the 128x128 int8 MXU.  That design was sized to
// the MXU; this one computes the same function with split-nibble tables
// on the integer units (gf8_nibble.cuh).
//
// Bound: bytes.  Each input byte is read once and each output byte written
// once, (k + r) * n * B bytes: at the path's shape (6 stripes x 12 + 4
// rows x 873,814 bytes) 83.9 MB, 0.025 ms at 3.35 TB/s.  The product is
// about 34 integer instructions per data word and four output rows (~6
// for the selectors, then per row two lookups of 2 PRMT + 1 LOP3 and one
// XOR): 16.7 M warp instructions at that shape, ~16 us on 132 SMs at
// 1,980 MHz, below the bytes but not far.
//
// What held the first version back (PERF.md): each thread loaded 16
// columns of every row, and rows start anywhere (873,814 = 6 mod 16), so
// almost every load and store went byte by byte; its product was
// exp[log x + log c], 80 data-dependent shared lookups per 16 columns,
// data row and four output rows; and r > 4 re-read the inputs per pass.
//
// Design: one block per (column tile, stripe), one stage, no pipeline:
//   * the block stages the stretch [c0, c0 + w) of all k input rows with
//     cp.async (ring.cuh): 16-byte chunks aligned to the device address,
//     so a shared row keeps its device alignment mod 16, and only the
//     chunks at a row's own two ends go byte by byte;
//   * per pass of four output rows it copies the pass's (k, 4, 32)
//     split-nibble tables into shared memory (once when r <= 4).  Lane l
//     of a warp takes the 4-byte words l, l + 32, l + 64 and l + 96 of its
//     warp's 512-byte stretch, each two aligned shared words joined by one
//     funnel shift, so a warp reads consecutive words (no bank conflict);
//     a data row's tables are read once (the same address in every lane)
//     for its four words, and the products go to registers;
//   * the results go to a shared output buffer, aligned (column c at
//     s + c); after a barrier store_chunk writes each output row to the
//     device in aligned 16-byte chunks, bytes only at the row's ends;
//   * r > 4 runs more passes over the same staged input.
// The geometry (tile, threads, shared bytes) comes from the host plan,
// ops/rs_kernels.py::plan; the launch checks it and recomputes nothing.
//
// Strides are in bytes and free on the batch and row axes; the column
// axis is dense.  `tabs` is (k, r4, 32) from ops/gf8.py::nibble_tables,
// r4 = r rounded up to a multiple of 4.  The launch returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "gf8_nibble.cuh"
#include "ring.cuh"

namespace {

using namespace gf8;

constexpr int kRT = 4;             // output rows per pass
constexpr int kWords = 4;          // words per lane in a warp's stretch
constexpr int kMaxThreads = 256;
constexpr int kMaxRows = 256;      // k and r each
constexpr int kMaxSmem = 232448;   // opt-in shared memory of one H100 block

struct Geometry {
  long long in_bstride, in_rstride, out_bstride, out_rstride, n;
  int B, k, r, r4, tile;
};

// Shared layout: the pass's tables (k x 4 x 2 uint4), kRT output rows,
// k input rows.  An input row holds up to 15 alignment bytes, the
// stretch and the word past it that a funnel shift reads; an output row
// the stretch and the 3 bytes past a chunk that store_chunk's read16
// reads.  The host plan computes the same total.
__host__ __device__ inline int in_pitch(int tile) { return tile + 32; }
__host__ __device__ inline int out_pitch(int tile) { return tile + 16; }
__host__ inline int smem_bytes(int k, int tile) {
  return k * kRT * 32 + kRT * out_pitch(tile) + k * in_pitch(tile);
}

__global__ void __launch_bounds__(kMaxThreads)
gf8_apply_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 const uint4* __restrict__ tabs, Geometry g) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint4* s_tab = reinterpret_cast<uint4*>(smem);
  uint8_t* s_out = smem + g.k * kRT * 32;
  uint8_t* s_in = s_out + kRT * out_pitch(g.tile);
  const int ip = in_pitch(g.tile), op = out_pitch(g.tile);
  const long long c0 = static_cast<long long>(blockIdx.x) * g.tile;
  const int w = static_cast<int>(g.n - c0 < g.tile ? g.n - c0 : g.tile);
  const int nc = ring::chunks(w), words = (w + 3) >> 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int step = (blockDim.x >> 5) * 32 * kWords;  // words per round

  for (int b = blockIdx.y; b < g.B; b += gridDim.y) {
    const uint8_t* in_b = in + b * g.in_bstride;
    uint8_t* out_b = out + b * g.out_bstride;
    __syncthreads();  // the previous stripe is done with shared memory
    for (int i = threadIdx.x; i < g.k * nc; i += blockDim.x) {
      const int j = i / nc;
      ring::copy_chunk(in_b + j * g.in_rstride, g.n, c0, w, s_in + j * ip, i - j * nc);
    }
    ring::commit();
    for (int og = 0; og < g.r; og += kRT) {
      if (og > 0) __syncthreads();  // the previous pass is done with s_tab, s_out
      for (int i = threadIdx.x; i < g.k * 2 * kRT; i += blockDim.x) {
        const int j = i / (2 * kRT);
        s_tab[i] = tabs[(j * g.r4 + og) * 2 + (i - j * 2 * kRT)];
      }
      ring::wait_group<0>();
      __syncthreads();
      for (int w0 = warp * 32 * kWords; w0 < words; w0 += step) {
        const int i0 = w0 + lane;  // this lane's words: i0 + 32 m
        bool live[kWords];         // inside the stretch
#pragma unroll
        for (int m = 0; m < kWords; ++m) live[m] = i0 + 32 * m < words;
        uint32_t acc[kRT][kWords];
#pragma unroll
        for (int o = 0; o < kRT; ++o)
#pragma unroll
          for (int m = 0; m < kWords; ++m) acc[o][m] = 0;
        const uint8_t* row = in_b + c0;  // row j's stretch on the device
        const uint8_t* srow = s_in;      // and its shared copy
        const uint4* tj = s_tab;         // and its tables
        for (int j = 0; j < g.k; ++j, row += g.in_rstride, srow += ip, tj += 2 * kRT) {
          uint4 t[kRT][2];
#pragma unroll
          for (int o = 0; o < kRT; ++o) {
            t[o][0] = tj[2 * o];
            t[o][1] = tj[2 * o + 1];
          }
          const ring::Reader rd(srow + (reinterpret_cast<uintptr_t>(row) & 15));
#pragma unroll
          for (int m = 0; m < kWords; ++m) {
            const Sel s = selectors(live[m] ? rd.read4(i0 + 32 * m) : 0u);
#pragma unroll
            for (int o = 0; o < kRT; ++o)
              acc[o][m] ^= lookup(t[o][0], s.slo, s.mlo) ^ lookup(t[o][1], s.shi, s.mhi);
          }
        }
#pragma unroll
        for (int m = 0; m < kWords; ++m)
          if (live[m])
#pragma unroll
            for (int o = 0; o < kRT; ++o)
              reinterpret_cast<uint32_t*>(s_out + o * op)[i0 + 32 * m] = acc[o][m];
      }
      __syncthreads();  // every output word is in
      const int rows = g.r - og < kRT ? g.r - og : kRT;
      for (int i = threadIdx.x; i < rows * nc; i += blockDim.x) {
        const int o = i / nc;
        store_chunk(out_b + (og + o) * g.out_rstride + c0, w, s_out + o * op, i - o * nc);
      }
    }
  }
}

}  // namespace

extern "C" int mt_gf8_apply(const void* in, long long in_bstride, long long in_rstride,
                            void* out, long long out_bstride, long long out_rstride,
                            const void* tabs, int B, int k, int r, long long n, int tile,
                            int threads, int smem, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (k < 1 || k > kMaxRows || r < 1 || r > kMaxRows || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || tile < 16 * threads ||
      tile % (16 * threads) != 0 || smem != smem_bytes(k, tile) || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf8_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Geometry g{in_bstride, in_rstride, out_bstride, out_rstride, n,
                   B, k, r, (r + kRT - 1) / kRT * kRT, tile};
  const dim3 grid(static_cast<unsigned>((n + tile - 1) / tile),
                  static_cast<unsigned>(B < 65535 ? B : 65535));
  gf8_apply_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const uint4*>(tabs), g);
  return static_cast<int>(cudaGetLastError());
}
