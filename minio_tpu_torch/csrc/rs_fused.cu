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
// Bounds.  Bytes: data read once, parity and digests written once, over
// 3.35 TB/s: 0.025 ms for a 64 MiB PUT batch (6 stripes x 12 + 4 rows x
// 873,814 bytes).  The chain: each hashed row is n / 32 dependent packet
// updates, then the remainder and 10 permute rounds (27,317 updates at
// 873,814 bytes), 0.55 ms at 1,980 MHz (chip_smoke.py's chain bound).
// The product, a stripe's 42 M byte products, is work for the integer
// units of the stripe's one SM beside the hash: about 12 instructions per
// byte column and data row here (cuobjdump -sass), at 2 cycles per warp
// instruction on each of 3 schedulers.  At the path's shape that is about
// 2.2 ms on an H100, above the chain, so the product paces this kernel
// (PERF.md).
//
// What held the first version back (PERF.md; NVIDIA H100 80GB HBM3 at
// 700 W, as all times here): its tile loads, its
// GF(2^8) product (60 dependent shared-memory log/exp lookups per byte
// column and four parity rows) and its hash ran as three phases in series
// between __syncthreads, the hash on 16 threads of one warp issuing the
// whole update per row: 10.29 ms, of which 6.49 ms without the hash.
// This design is a warp-specialised pipeline, one block per stripe:
//   * warp 4, the producer, fills a ring of kStages stages, each `tile`
//     bytes of the k data rows, with cp.async (consecutive lanes on
//     consecutive 16-byte chunks of a row), and marks a stage full on an
//     mbarrier once its copies have landed.  Only a row's two ends are
//     copied byte by byte (ring.cuh): byte copies at every stage edge
//     would cost each stage a device-memory round trip per row;
//   * warps 1-3 and 5-7, the product warps (on schedulers 1-3: warp w
//     issues on scheduler w mod 4), compute each stage's parity into the
//     ring, mark it on a second mbarrier, and store it to device memory.
//     The product uses split-nibble tables (gf8_nibble.cuh, shared with
//     Kernel A), the GPU form of the PSHUFB method of
//     klauspost/reedsolomon's galMulAVX2: c * x =
//     Tlo[c][x & 15] ^ Thi[c][x >> 4].  A coefficient's two 16-byte tables
//     are loaded into registers (two 16-byte loads, the same address in
//     every lane) and looked up four data bytes at a time: __byte_perm
//     picks entries 0-7 and 8-15 of each table by the nibble's low three
//     bits, and a byte mask from its bit 3 selects between them.  The
//     nibble selectors of a data word serve all parity rows, and the next
//     data row's tables load while this one's are used;
//   * warp 0, the hashing warp (scheduler 0, shared only with the light
//     producer), hashes 16 rows with two lanes each (hh256_core.cuh) from
//     the ring, behind the product, and marks the stage empty on a third
//     mbarrier, which the product warps also arrive on; the producer waits
//     for it before refilling the slot.  Stripes of more than 16 hashed
//     rows (k + ro up to 256) add a hashing warp per 16 rows (warps 8 on),
//     which share schedulers with the product warps.
// A tensor-core product (int8 mma on 0/1 bit planes, as the TPU kernel
// does on its MXU) would free the integer units, but expanding bytes to
// bit planes and packing the sums back costs about as many integer
// instructions as the table lookups it replaces.
//
// Layout: data rows keep their device alignment mod 16 in the ring
// (ring.cuh); parity rows are written aligned (column c at row + c) and
// the store realigns them to the device rows in 16-byte chunks, bytes at
// the ends, so no byte outside the parity rows is written.  The row pitch
// is tile + 16, 16 mod 128 bytes.
//
// Strides are in bytes and free on the batch and row axes of the data and
// the parity; the column axis is dense.  Digests cover the first n_hash
// bytes of each row (n_hash <= n) and go to a dense (B, R, 32) tensor.
// `tabs` holds Tlo then Thi (32 bytes) for each coefficient, (k, ro4)
// row-major, ro4 = ro rounded up to a multiple of 4, zero past ro.  The
// launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "gf8_nibble.cuh"
#include "hh256_core.cuh"
#include "ring.cuh"

namespace {

using namespace gf8;

constexpr int kStages = 4;          // ring slots
constexpr int kMaxRows = 256;       // k + ro
constexpr int kHashRows = 16;       // rows per hashing warp, two lanes each
constexpr int kProdThreads = 192;   // warps 1-3 and 5-7
constexpr int kProducerWarp = 4;
constexpr int kWPT = 4;             // parity words per product thread and pass
constexpr int kRT = 4;              // parity rows per pass
constexpr int kBarBytes = 128;      // 3 x kStages mbarriers
constexpr int kSlack = 16;          // reads past the ring's last row
constexpr int kMaxSmem = 232448;    // opt-in shared memory of one H100 block

struct Geometry {
  long long in_bstride, in_rstride, par_bstride, par_rstride, n, n_hash;
  int B, k, ro, ro4, R, tile, hash_warps;
};

__host__ __device__ inline int pitch_of(int tile) { return tile + 16; }

// shared memory in bytes; the host plan (ops/rs_fused.py::plan) computes
// the same total
__host__ inline int smem_bytes(int k, int ro, int tile) {
  return kBarBytes + kStages * (k + ro) * pitch_of(tile) + kSlack;
}

__device__ __forceinline__ int width(const Geometry& g, long long c0) {
  return static_cast<int>(g.n - c0 < g.tile ? g.n - c0 : g.tile);
}

__device__ void producer(const uint8_t* __restrict__ in, const Geometry& g, uint8_t* ring,
                         uint64_t* full, uint64_t* empty) {
  const int lane = threadIdx.x & 31;
  const int pitch = pitch_of(g.tile), slot_bytes = (g.k + g.ro) * pitch;
  unsigned gi = 0;  // stages issued by this block so far
  for (int b = blockIdx.x; b < g.B; b += gridDim.x) {
    const uint8_t* in_b = in + b * g.in_bstride;
    for (long long c0 = 0; c0 < g.n; c0 += g.tile, ++gi) {
      const int slot = gi % kStages;
      if (gi >= kStages) ring::bar_wait(&empty[slot], (gi / kStages - 1) & 1);
      const int w = width(g, c0), nc = ring::chunks(w);
      uint8_t* base = ring + slot * slot_bytes;
      for (int j = 0; j < g.k; ++j)
        for (int q = lane; q < nc; q += 32)
          ring::copy_chunk(in_b + j * g.in_rstride, g.n, c0, w, base + j * pitch, q);
      ring::commit();
      if (gi >= 1) {  // the previous stage's copies have landed
        ring::wait_group<1>();
        ring::bar_arrive(&full[(gi - 1) % kStages]);
      }
    }
  }
  if (gi >= 1) {
    ring::wait_group<0>();
    ring::bar_arrive(&full[(gi - 1) % kStages]);
  }
}

__device__ void product(const uint8_t* __restrict__ in, uint8_t* __restrict__ par,
                        const uint4* __restrict__ tabs, const Geometry& g, uint8_t* ring,
                        uint64_t* full, uint64_t* prod, uint64_t* empty, int pt) {
  const int pitch = pitch_of(g.tile), slot_bytes = (g.k + g.ro) * pitch;
  unsigned gi = 0;
  for (int b = blockIdx.x; b < g.B; b += gridDim.x) {
    const uint8_t* in_b = in + b * g.in_bstride;
    uint8_t* par_b = par + b * g.par_bstride;
    for (long long c0 = 0; c0 < g.n; c0 += g.tile, ++gi) {
      const int slot = gi % kStages;
      ring::bar_wait(&full[slot], (gi / kStages) & 1);
      const int w = width(g, c0), words = (w + 3) >> 2;
      uint8_t* base = ring + slot * slot_bytes;
      uint8_t* pbase = base + g.k * pitch;
      for (int c4 = pt * kWPT; c4 < words; c4 += kProdThreads * kWPT) {
        for (int og = 0; og < g.ro; og += kRT) {
          uint32_t acc[kRT][kWPT];
#pragma unroll
          for (int o = 0; o < kRT; ++o)
#pragma unroll
            for (int m = 0; m < kWPT; ++m) acc[o][m] = 0;
          // tables of data row j, parity rows og..og + 3, loaded one data
          // row ahead of their use into the other of two buffers
          auto load_tabs = [&](int j, uint4(&t)[kRT][2]) {
            const uint4* p = tabs + 2 * (j * g.ro4 + og);
#pragma unroll
            for (int o = 0; o < kRT; ++o) {
              t[o][0] = __ldg(p + 2 * o);
              t[o][1] = __ldg(p + 2 * o + 1);
            }
          };
          auto step = [&](int j, const uint4(&t)[kRT][2]) {
            const int off = static_cast<int>(
                reinterpret_cast<uintptr_t>(in_b + j * g.in_rstride) & 15);
            uint64_t d01, d23;
            ring::read16(base + j * pitch + off + 4 * c4, d01, d23);
            const uint32_t x[kWPT] = {static_cast<uint32_t>(d01), static_cast<uint32_t>(d01 >> 32),
                                      static_cast<uint32_t>(d23), static_cast<uint32_t>(d23 >> 32)};
            Sel s[kWPT];
#pragma unroll
            for (int m = 0; m < kWPT; ++m) s[m] = selectors(x[m]);
#pragma unroll
            for (int o = 0; o < kRT; ++o)
#pragma unroll
              for (int m = 0; m < kWPT; ++m)
                acc[o][m] ^= lookup(t[o][0], s[m].slo, s[m].mlo) ^
                             lookup(t[o][1], s[m].shi, s[m].mhi);
          };
          uint4 ta[kRT][2], tb[kRT][2];
          load_tabs(0, ta);
          for (int j = 0; j < g.k; j += 2) {
            if (j + 1 < g.k) load_tabs(j + 1, tb);
            step(j, ta);
            if (j + 1 < g.k) {
              if (j + 2 < g.k) load_tabs(j + 2, ta);
              step(j + 1, tb);
            }
          }
#pragma unroll
          for (int o = 0; o < kRT; ++o)
#pragma unroll
            for (int m = 0; m < kWPT; ++m)
              if (og + o < g.ro && c4 + m < words)
                reinterpret_cast<uint32_t*>(pbase + (og + o) * pitch)[c4 + m] = acc[o][m];
        }
      }
      ring::bar_arrive(&prod[slot]);
      ring::bar_wait(&prod[slot], (gi / kStages) & 1);  // every parity word is in
      const int nc = ring::chunks(w);
      for (int idx = pt; idx < g.ro * nc; idx += kProdThreads) {
        const int o = idx / nc, q = idx - o * nc;
        store_chunk(par_b + o * g.par_rstride + c0, w, pbase + o * pitch, q);
      }
      ring::bar_arrive(&empty[slot]);
    }
  }
}

__device__ void hasher(const uint8_t* __restrict__ in, uint8_t* __restrict__ dig,
                       const hh::Key& key, const Geometry& g, uint8_t* ring, uint64_t* prod,
                       uint64_t* empty, int hw) {
  const int lane = threadIdx.x & 31, r = lane >> 1, h = lane & 1;
  const int ri = hw * kHashRows + r;
  const bool hashing = ri < g.R;
  const int pitch = pitch_of(g.tile), slot_bytes = (g.k + g.ro) * pitch;
  unsigned gi = 0;
  for (int b = blockIdx.x; b < g.B; b += gridDim.x) {
    const uint8_t* in_b = in + b * g.in_bstride;
    // data rows keep their device alignment in the ring, parity rows none
    const int off = hashing && ri < g.k ? static_cast<int>(reinterpret_cast<uintptr_t>(
                                              in_b + ri * g.in_rstride) & 15)
                                        : 0;
    hh::HalfState st;
    hh::init_half(st, key, h);
    for (long long c0 = 0; c0 < g.n; c0 += g.tile, ++gi) {
      const int slot = gi % kStages;
      ring::bar_wait(&prod[slot], (gi / kStages) & 1);
      const long long left = g.n_hash - c0;
      const int w = width(g, c0);
      const int hwid = left <= 0 ? 0 : left < w ? static_cast<int>(left) : w;
      if (hashing) {
        const uint8_t* row = ring + slot * slot_bytes + ri * pitch + off + 16 * h;
        const int packets = hwid >> 5;
        if (packets > 0) {
          const ring::Reader rd(row);
          uint64_t a, bb, na, nb;
          rd.read16(0, a, bb);
          for (int q = 1; q < packets; ++q) {
            rd.read16(8 * q, na, nb);
            hh::update_half(st, a, bb);
            a = na;
            bb = nb;
          }
          hh::update_half(st, a, bb);
        }
        // hwid % 32 != 0 only in the stage where the hashed width ends
        if (hwid & 31) hh::remainder_half(st, h, row - 16 * h + 32 * packets, hwid & 31);
      }
      ring::bar_arrive(&empty[slot]);
    }
    hh::finish256_half(st, h, dig + (static_cast<long long>(b) * g.R + (hashing ? ri : 0)) * 32,
                       hashing, 0xFFFFFFFFu);
  }
}

// kWide: more than one hashing warp (R > 16), a block of up to 23 warps
template <bool kWide>
__global__ void __launch_bounds__(32 * (kWide ? 7 + kMaxRows / kHashRows : 8))
rs_fused_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ par,
                const uint4* __restrict__ tabs, uint8_t* __restrict__ dig, hh::Key key,
                Geometry g) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* prod = full + kStages;
  uint64_t* empty = prod + kStages;
  uint8_t* ring = smem + kBarBytes;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      ring::bar_init(&full[i], 32);
      ring::bar_init(&prod[i], kProdThreads);
      ring::bar_init(&empty[i], kProdThreads + 32 * g.hash_warps);
    }
  }
  __syncthreads();
  // roles by warp; none meets another at a block barrier after this
  const int warp = threadIdx.x >> 5;
  if (warp == kProducerWarp)
    producer(in, g, ring, full, empty);
  else if (warp == 0 || warp >= 8)
    hasher(in, dig, key, g, ring, prod, empty, warp == 0 ? 0 : warp - 7);
  else
    product(in, par, tabs, g, ring, full, prod, empty,
            (warp < kProducerWarp ? warp - 1 : warp - 2) * 32 + (threadIdx.x & 31));
}

}  // namespace

extern "C" int mt_rs_fused(const void* in, long long in_bstride, long long in_rstride,
                           void* par, long long par_bstride, long long par_rstride,
                           const void* tabs, void* dig, int B, int k, int ro, int hash_parity,
                           long long n, long long n_hash, int tile, int stages,
                           unsigned long long k0, unsigned long long k1,
                           unsigned long long k2, unsigned long long k3, void* stream) {
  if (B <= 0) return 0;
  const int R = k + (hash_parity ? ro : 0);
  if (k < 1 || ro < 1 || k + ro > kMaxRows || n < 0 || n_hash < 0 || n_hash > n ||
      tile < 128 || tile % 128 != 0 || stages != kStages)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(k, ro, tile);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int hash_warps = (R + kHashRows - 1) / kHashRows;
  const bool wide = hash_warps > 1;
  auto kernel = wide ? rs_fused_kernel<true> : rs_fused_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Geometry g{in_bstride, in_rstride, par_bstride, par_rstride, n, n_hash,
                   B, k, ro, (ro + kRT - 1) / kRT * kRT, R, tile, hash_warps};
  const hh::Key key{{k0, k1, k2, k3}};
  const int warps = 7 + hash_warps;
  const unsigned grid = static_cast<unsigned>(B < 65535 ? B : 65535);
  kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(par),
      static_cast<const uint4*>(tabs), static_cast<uint8_t*>(dig), key, g);
  return static_cast<int>(cudaGetLastError());
}
