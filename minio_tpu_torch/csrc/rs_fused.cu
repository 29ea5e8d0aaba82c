// Fused Reed-Solomon encode + keyed HighwayHash-256 for Hopper (Kernel C).
//
// For every stripe b of a (B, k, n) batch: parity[b] = M (GF) @ data[b]
// over GF(2^8), and the HighwayHash-256 digest of each data row and, with
// hash_parity, of each parity row.  The data is read from device memory
// once; parity and digests are written once.
//
// Replaces the TPU kernel minio_tpu/ops/rs_fused.py::_kernel (through
// _fused_call), which ran the encode on the MXU and carried the hash state
// across lane tiles as u32 limb planes, leaving the remainder packet, the
// permute rounds and the reduction to XLA (_digests_from_planes).  Here the
// kernel finishes the digests itself, as hh256.cu does.
//
// Bound: the per-row packet chain, not bytes.  Each row is a chain of
// n / 32 dependent packet updates; at the PUT path's widths (873,814-byte
// shards) that chain takes far longer than moving the stripe's bytes.  The
// standalone hash kernel (hh256.cu) feeds its chain from device memory and
// waits on memory latency between packets; here the chain reads packets
// from shared memory, which the block filled for the GF(2^8) product
// anyway, so no update waits on device memory.  The rows of a stripe share
// one warp, so each packet costs that warp the update's instructions in
// series: the instruction count, more than the dependency latency, sets
// the pace (PERF.md, PR 3).
//
// Design (first, simple version):
//   * one thread block owns one stripe and walks its width in tiles of
//     `tile` bytes (a multiple of 32; the host plan picks it so the data
//     and parity tiles fit the shared-memory budget);
//   * phase 1: all threads copy the tile of the k data rows into shared
//     memory.  Rows start anywhere (873,814 mod 16 = 6): a row's tile is
//     copied in 16-byte chunks aligned to its device address, as vectors
//     where the chunk lies inside the row and byte by byte at its two
//     ends, so no load leaves the row.  The shared row keeps the device
//     row's alignment mod 16 (row byte c at s_row + (addr & 15) + c);
//   * phase 2: all threads compute the tile of the ro parity rows into
//     shared memory, byte by byte, with the log/exp tables and the zero
//     sentinel of gf8_apply.cu (log 0 = 510, exp[i >= 510] = 0), then
//     store them to device memory the same chunked way;
//   * phase 3: thread i < R (R = k, or k + ro with hash_parity) advances
//     row i's state over the tile's packets, read from shared memory as
//     aligned 8-byte words; the state stays in registers across tiles.
//     After the last tile it hashes the remainder packet, runs the 10
//     permute rounds and the reduction, and writes the digest.
//   __syncthreads() separates the phases.  Overlapping the next tile's
//   loads with this tile's hashing is later work.
//
// Strides are in bytes and free on the batch and row axes of the data and
// the parity; the column axis is dense.  Digests cover the first n_hash
// bytes of each row (n_hash <= n) and go to a dense (B, R, 32) tensor.
// The launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "hh256_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 256;    // k + ro: one hashing thread per row
constexpr int kExpLen = 1024;    // exp table, zero from index 510 on
constexpr int kRT = 4;           // parity rows per pass of the GF loop
constexpr int kPad = 32;         // row pitch = tile + kPad (see load_packet)
constexpr int kMaxSmem = 232448; // opt-in shared memory of one H100 block

struct Geometry {
  long long in_bstride, in_rstride, par_bstride, par_rstride, n, n_hash;
  int B, k, ro, R, tile;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// shared-memory layout in bytes; the host plan (ops/rs_fused.py::plan)
// computes the same total
struct Layout {
  int log, coef, off, data, par, pitch, total;
  __host__ __device__ Layout(int k, int ro, int tile) {
    pitch = tile + kPad;
    log = kExpLen;                                   // u16[256]
    coef = log + 512;                                // u16[ro4][k]
    off = coef + align16(2 * k * ((ro + kRT - 1) / kRT * kRT));
    data = off + align16(k + ro);                    // u8 offsets
    par = data + k * pitch;
    total = par + ro * pitch;
  }
};

// global row tile [src, src + w) -> shared row buffer s (16-aligned):
// device byte src + c lands at s + (src & 15) + c.  Work items are
// (row, chunk) pairs over all rows, strided over the block's threads.
__device__ __forceinline__ void load_rows(const uint8_t* base, long long rstride, int rows,
                                          long long c0, int w, uint8_t* s, int pitch) {
  const int chunks = (w + 30) / 16;  // ceil((15 + w) / 16)
  for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
    const int j = idx / chunks, q = idx - j * chunks;
    const uint8_t* src = base + j * rstride + c0;
    const int lo = 16 * q - static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
    if (lo >= w) continue;
    uint8_t* dst = s + j * pitch + 16 * q;
    if (lo >= 0 && lo + 16 <= w) {
      *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src + lo));
    } else {
#pragma unroll
      for (int t = 0; t < 16; ++t)
        if (lo + t >= 0 && lo + t < w) dst[t] = src[lo + t];
    }
  }
}

// shared row buffers -> global row tiles, the inverse of load_rows
__device__ __forceinline__ void store_rows(uint8_t* base, long long rstride, int rows,
                                           long long c0, int w, const uint8_t* s, int pitch) {
  const int chunks = (w + 30) / 16;  // ceil((15 + w) / 16)
  for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
    const int j = idx / chunks, q = idx - j * chunks;
    uint8_t* dst = base + j * rstride + c0;
    const int lo = 16 * q - static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
    if (lo >= w) continue;
    const uint8_t* src = s + j * pitch + 16 * q;
    if (lo >= 0 && lo + 16 <= w) {
      *reinterpret_cast<uint4*>(dst + lo) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int t = 0; t < 16; ++t)
        if (lo + t >= 0 && lo + t < w) dst[lo + t] = src[t];
    }
  }
}

// the 4 little-endian words of the packet at p, p in a shared row buffer.
// Reads the 5 aligned words that cover it: at most 7 bytes past the
// packet, inside the row's kPad slack.
__device__ __forceinline__ void load_packet(const uint8_t* p, uint64_t (&lanes)[4]) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const int sh = static_cast<int>(addr & 7) * 8;
  const uint64_t* w = reinterpret_cast<const uint64_t*>(addr & ~uintptr_t(7));
  uint64_t x[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) x[i] = w[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) lanes[i] = sh ? (x[i] >> sh) | (x[i + 1] << (64 - sh)) : x[i];
}

__global__ void __launch_bounds__(kThreads)
rs_fused_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ par,
                const uint16_t* __restrict__ coef_log,  // (ro, k)
                const uint16_t* __restrict__ log_tab,   // (256,)
                const uint8_t* __restrict__ exp_tab,    // (1024,)
                uint8_t* __restrict__ dig, hh::Key key, Geometry g) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L(g.k, g.ro, g.tile);
  uint8_t* s_exp = smem;
  uint16_t* s_log = reinterpret_cast<uint16_t*>(smem + L.log);
  uint16_t* s_coef = reinterpret_cast<uint16_t*>(smem + L.coef);
  uint8_t* s_off = smem + L.off;
  uint8_t* s_data = smem + L.data;
  uint8_t* s_par = smem + L.par;
  const int ro4 = (g.ro + kRT - 1) / kRT * kRT;

  for (int i = threadIdx.x; i < kExpLen; i += blockDim.x) s_exp[i] = exp_tab[i];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_log[i] = log_tab[i];
  for (int i = threadIdx.x; i < ro4 * g.k; i += blockDim.x)
    s_coef[i] = i < g.ro * g.k ? coef_log[i] : 510;

  for (int b = blockIdx.x; b < g.B; b += gridDim.x) {
    const uint8_t* in_b = in + b * g.in_bstride;
    uint8_t* par_b = par + b * g.par_bstride;
    __syncthreads();  // the previous stripe's last hash phase is done
    for (int i = threadIdx.x; i < g.k + g.ro; i += blockDim.x) {
      const uint8_t* row = i < g.k ? in_b + i * g.in_rstride : par_b + (i - g.k) * g.par_rstride;
      s_off[i] = static_cast<uint8_t>(reinterpret_cast<uintptr_t>(row) & 15);
    }

    hh::State st;
    const int me = threadIdx.x;
    const bool hashing = me < g.R;
    if (hashing) hh::init(st, key);

    for (long long c0 = 0; c0 < g.n; c0 += g.tile) {
      const int w = static_cast<int>(g.n - c0 < g.tile ? g.n - c0 : g.tile);
      __syncthreads();  // previous tile's hash phase is done with the buffers
      load_rows(in_b, g.in_rstride, g.k, c0, w, s_data, L.pitch);
      __syncthreads();

      for (int c = threadIdx.x; c < w; c += blockDim.x) {
        for (int og = 0; og < g.ro; og += kRT) {
          uint8_t acc[kRT];
#pragma unroll
          for (int o = 0; o < kRT; ++o) acc[o] = 0;
          for (int j = 0; j < g.k; ++j) {
            const int lx = s_log[s_data[j * L.pitch + s_off[j] + c]];
            const uint16_t* lc = s_coef + og * g.k + j;
#pragma unroll
            for (int o = 0; o < kRT; ++o) acc[o] ^= s_exp[lx + lc[o * g.k]];
          }
#pragma unroll
          for (int o = 0; o < kRT; ++o) {
            const int r = og + o;
            if (r < g.ro) s_par[r * L.pitch + s_off[g.k + r] + c] = acc[o];
          }
        }
      }
      __syncthreads();
      store_rows(par_b, g.par_rstride, g.ro, c0, w, s_par, L.pitch);

      if (hashing) {
        const long long left = g.n_hash - c0;
        const int hw = left <= 0 ? 0 : left < w ? static_cast<int>(left) : w;
        const uint8_t* row = me < g.k ? s_data + me * L.pitch + s_off[me]
                                      : s_par + (me - g.k) * L.pitch + s_off[me];
        const int packets = hw >> 5;
        if (packets > 0) {
          uint64_t cur[4], nxt[4];
          load_packet(row, cur);
          for (int p = 1; p < packets; ++p) {
            load_packet(row + 32 * p, nxt);
            hh::update(st, cur);
#pragma unroll
            for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
          }
          hh::update(st, cur);
        }
        // hw % 32 != 0 only in the tile where the hashed width ends
        if (hw & 31) hh::remainder(st, row + 32 * packets, hw & 31);
      }
    }
    if (hashing) hh::finish256(st, dig + (static_cast<long long>(b) * g.R + me) * 32);
  }
}

}  // namespace

extern "C" int mt_rs_fused(const void* in, long long in_bstride, long long in_rstride,
                           void* par, long long par_bstride, long long par_rstride,
                           const void* coef_log, const void* log_tab, const void* exp_tab,
                           void* dig, int B, int k, int ro, int hash_parity, long long n,
                           long long n_hash, int tile, unsigned long long k0,
                           unsigned long long k1, unsigned long long k2,
                           unsigned long long k3, void* stream) {
  if (B <= 0) return 0;
  const int R = k + (hash_parity ? ro : 0);
  if (k < 1 || ro < 1 || k + ro > kMaxRows || n < 0 || n_hash < 0 || n_hash > n ||
      tile < 32 || tile % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L(k, ro, tile);
  if (L.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (L.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rs_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Geometry g{in_bstride, in_rstride, par_bstride, par_rstride, n, n_hash,
                   B, k, ro, R, tile};
  const hh::Key key{{k0, k1, k2, k3}};
  const unsigned grid = static_cast<unsigned>(B < 65535 ? B : 65535);
  rs_fused_kernel<<<grid, kThreads, L.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(par),
      static_cast<const uint16_t*>(coef_log), static_cast<const uint16_t*>(log_tab),
      static_cast<const uint8_t*>(exp_tab), static_cast<uint8_t*>(dig), key, g);
  return static_cast<int>(cudaGetLastError());
}
