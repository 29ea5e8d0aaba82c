// Keyed HighwayHash (256- and 64-bit finalization) of many rows, for Hopper
// (Kernel B).
//
// Replaces the TPU kernel minio_tpu/ops/hh_pallas.py::_kernel_nat
// (through _run_nat and hh256_batch), whose packet loop carries the state
// as u32 hi/lo limb planes because the TPU has no 64-bit integers, with
// the remainder packet and finalization left to XLA
// (hh_kernels._remainder_update, hh_pallas._finalize).  Here the kernel
// hashes each row start to finish in native uint64_t: the 32-byte packet
// chain, the remainder packet, the permute rounds and the modular
// reduction, and writes the digest.
//
// Bounds.  Bytes: each row read once, 32 (or 8) bytes written, over
// 3.35 TB/s: 0.025 ms for a 64 MiB PUT batch (96 rows x 873,814 bytes).
// The chain: a row is n / 32 dependent packet updates, then the remainder
// and 10 permute rounds (27,317 updates at 873,814 bytes), each at least
// the update's 10 dependent integer instructions (chip_smoke.py's chain
// bound, 0.55 ms at 1,980 MHz).  The chain binds.
//
// What held the first version back (PERF.md; NVIDIA H100 80GB HBM3 at
// 700 W, as all times here): one thread per row
// and 32 rows per block put a 96-row batch on 3 SMs, and each packet was
// loaded from device memory one packet ahead, 32 rows ~874 KB apart per
// warp load: 549 ns per packet at 96 rows, against 139 ns for the same
// update fed from shared memory.  This design:
//   * two threads per row, adjacent lanes, one per half of the state
//     (hh256_core.cuh): each thread issues half the update's instructions,
//     and the pair meets only in the finalization's permute rounds;
//   * each warp is its own pipeline: all 32 lanes copy its rows' packets
//     into a ring of kStages stages of `tile` bytes per row in shared
//     memory with cp.async (consecutive lanes on consecutive 16-byte
//     chunks of a row, so the loads coalesce), kStages - 1 stages ahead of
//     the hash; cp.async.wait_group and __syncwarp hand a stage over, so
//     no warp waits on another.  Row addresses are worked out once (lane j
//     holds row j's), not per stage;
//   * few rows per warp and at most 4 warps per block: warp w issues on
//     scheduler w mod 4, so a block's hashing warps never share one; up
//     to 132 rows take one warp per block, one block per SM, so a 96-row
//     batch runs on 96 SMs (the host plan, ops/hh.py::plan, picks rows per
//     warp, warps and tile);
//   * the row pitch is tile + 16, 16 mod 128 bytes (tile is a multiple of
//     128): a warp's rows sit 4 banks apart, so 8-byte reads of up to 8
//     rows at one column hit distinct banks.
// Stages keep the device alignment mod 16 (ring.cuh); a half-packet is
// read as 5 aligned words joined with funnel shifts.  The tail (n % 32
// bytes) is read byte by byte.
//
// Input rows: row i = g * R + q lies at in + g * gstride + q * rstride,
// columns dense.  Output: out_bytes (32 or 8) little-endian bytes per row.
// The launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "hh256_core.cuh"
#include "ring.cuh"

namespace {

constexpr int kStages = 4;           // ring depth: stages in flight + the one hashed
constexpr int kMaxWarps = 4;         // one hashing warp per scheduler
constexpr int kMaxRowsPerWarp = 16;  // two lanes per row
constexpr int kSlack = 16;           // read16 past the last row of the ring
constexpr int kMaxSmem = 232448;     // opt-in shared memory of one H100 block

struct Plan {
  int rows_per_warp, warps, tile;
};

__host__ __device__ inline int pitch_of(int tile) { return tile + 16; }

__host__ inline int smem_bytes(const Plan& p) {
  return p.warps * p.rows_per_warp * kStages * pitch_of(p.tile) + kSlack;
}

template <int kOutBytes>
__global__ void __launch_bounds__(kMaxWarps * 32)
hh_kernel(const uint8_t* __restrict__ in, long long gstride, long long rstride, int R,
          long long rows, long long n, hh::Key key, uint8_t* __restrict__ out, Plan p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row0 = (static_cast<long long>(blockIdx.x) * p.warps + warp) * p.rows_per_warp;
  if (row0 >= rows) return;  // the whole warp: warps share nothing
  const int nrows = static_cast<int>(rows - row0 < p.rows_per_warp ? rows - row0 : p.rows_per_warp);
  const int pitch = pitch_of(p.tile);
  uint8_t* ring = smem + warp * p.rows_per_warp * kStages * pitch;  // [stage][row]
  const int r = lane >> 1, h = lane & 1;
  const bool hashing = r < nrows;
  auto row_ptr = [&](int j) {
    const long long i = row0 + j;
    return in + (i / R) * gstride + (i % R) * rstride;
  };
  // lane j holds row j's address (a 64-bit division, once), and every
  // stage's copy takes it from there
  const unsigned long long lane_row =
      reinterpret_cast<unsigned long long>(row_ptr(lane < nrows ? lane : 0));
  const int off = static_cast<int>(
      __shfl_sync(0xFFFFFFFFu, lane_row, hashing ? r : 0) & 15);

  hh::HalfState st;
  hh::init_half(st, key, h);

  const long long nst = (n + p.tile - 1) / p.tile;
  auto width = [&](long long s) {
    const long long left = n - s * p.tile;
    return static_cast<int>(left < p.tile ? left : p.tile);
  };
  // every lane copies stage s of the warp's rows; one commit group per
  // stage, empty past the last, so wait_group counts stay uniform
  auto issue = [&](long long s) {
    if (s < nst) {
      const int w = width(s);
      const int nc = ring::chunks(w);
      uint8_t* slot = ring + static_cast<int>(s % kStages) * p.rows_per_warp * pitch;
      for (int j = 0; j < nrows; ++j) {
        const uint8_t* row =
            reinterpret_cast<const uint8_t*>(__shfl_sync(0xFFFFFFFFu, lane_row, j));
        for (int q = lane; q < nc; q += 32)
          ring::copy_chunk(row, n, s * p.tile, w, slot + j * pitch, q);
      }
    }
    ring::commit();
  };

  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (long long s = 0; s < nst; ++s) {
    issue(s + kStages - 1);
    ring::wait_group<kStages - 1>();  // this lane's copies of stage s landed
    __syncwarp();                     // ... and every other lane's
    if (hashing) {
      const int w = width(s);
      const uint8_t* row =
          ring + (static_cast<int>(s % kStages) * p.rows_per_warp + r) * pitch + off + 16 * h;
      const int packets = w >> 5;
      if (packets > 0) {
        const ring::Reader rd(row);
        uint64_t a, b, na, nb;
        rd.read16(0, a, b);
        for (int q = 1; q < packets; ++q) {
          rd.read16(8 * q, na, nb);
          hh::update_half(st, a, b);
          a = na;
          b = nb;
        }
        hh::update_half(st, a, b);
      }
      // w % 32 != 0 only in the last stage (tile is a multiple of 32)
      if (w & 31) hh::remainder_half(st, h, row - 16 * h + 32 * packets, w & 31);
    }
    __syncwarp();  // stage s's slot is refilled by the next issue
  }

  uint8_t* dst = out + (row0 + (hashing ? r : 0)) * kOutBytes;
  if (kOutBytes == 8)
    hh::finish64_half(st, h, dst, hashing, 0xFFFFFFFFu);
  else
    hh::finish256_half(st, h, dst, hashing, 0xFFFFFFFFu);
}

}  // namespace

extern "C" int mt_hh_batch(const void* in, long long gstride, long long rstride, int R,
                           long long rows, long long n, unsigned long long k0,
                           unsigned long long k1, unsigned long long k2,
                           unsigned long long k3, void* out, int out_bytes,
                           int rows_per_warp, int warps, int tile, int stages, void* stream) {
  if (rows <= 0) return 0;
  if (R < 1 || n < 0 || (out_bytes != 32 && out_bytes != 8) || rows_per_warp < 1 ||
      rows_per_warp > kMaxRowsPerWarp || warps < 1 || warps > kMaxWarps || tile < 128 ||
      tile % 128 != 0 || stages != kStages)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{rows_per_warp, warps, tile};
  const int smem = smem_bytes(p);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = out_bytes == 32 ? hh_kernel<32> : hh_kernel<8>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long per_block = static_cast<long long>(warps) * rows_per_warp;
  const unsigned blocks = static_cast<unsigned>((rows + per_block - 1) / per_block);
  const hh::Key key{{k0, k1, k2, k3}};
  kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), gstride, rstride, R, rows, n, key,
      static_cast<uint8_t*>(out), p);
  return static_cast<int>(cudaGetLastError());
}
