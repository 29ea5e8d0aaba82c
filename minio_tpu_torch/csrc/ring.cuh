// Staging rows of device memory through shared memory, shared by
// gf8_apply.cu, hh256.cu and rs_fused.cu: cp.async copies of 16-byte
// chunks, unaligned reads from the staged rows, and the mbarrier calls of
// rs_fused.cu's pipeline.
//
// Rows start at any byte (a 12 + 4 set's 873,814-byte shards lie at
// 6 mod 16).  A stage, the stretch [c0, c0 + w) of a row, is staged in
// 16-byte chunks aligned to its device address, so the shared copy keeps
// the device alignment mod 16: device byte row + c0 + c lands at
// s + ((row + c0) & 15) + c, s 16-byte aligned.  The chunks at a stage's
// edges reach into the neighbouring stages, which are the same row's
// bytes: they go by cp.async like the rest.  Only the one or two chunks
// at the row's own ends, which reach outside the row, are copied byte by
// byte, so no load leaves the row.  (A byte copy waits on device memory
// where cp.async does not: at every stage edge it would cost a stage that
// latency.)

#pragma once

#include <stdint.h>

namespace ring {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// chunks of the shared copy of a w-byte stretch: ceil((15 + w) / 16)
__device__ __forceinline__ int chunks(int w) { return (w + 30) / 16; }

// chunk q of stage [c0, c0 + w) of an n-byte row into s (16-byte aligned)
__device__ __forceinline__ void copy_chunk(const uint8_t* row, long long n, long long c0, int w,
                                           uint8_t* s, int q) {
  const uint8_t* src = row + c0;
  const int lo = 16 * q - static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  if (lo >= w) return;
  const long long a = c0 + lo;  // the chunk's first column in the row
  if (a >= 0 && a + 16 <= n) {
    cp_async16(s + 16 * q, src + lo);
  } else {
#pragma unroll
    for (int t = 0; t < 16; ++t)
      if (a + t >= 0 && a + t < n) s[16 * q + t] = src[lo + t];
  }
}

// reads of a staged row at p in shared memory, any alignment: the aligned
// 32-bit words under it and the shift of its first byte, fixed per row
struct Reader {
  const uint32_t* w;
  uint32_t sh;
  // pointer arithmetic on p, not an integer round trip, keeps the loads
  // in the shared address space (LDS, not generic LD)
  __device__ __forceinline__ explicit Reader(const uint8_t* p) {
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
    w = reinterpret_cast<const uint32_t*>(p - mis);
    sh = static_cast<uint32_t>(mis) * 8;
  }
  // the 4 bytes at p + 4 * word: two aligned words, one funnel shift
  __device__ __forceinline__ uint32_t read4(int word) const {
    return __funnelshift_r(w[word], w[word + 1], sh);
  }
  // the 16 bytes at p + 4 * word as two little-endian words.  Reads the
  // five aligned words that cover them: up to 3 bytes past the 16, which
  // the layouts leave room for.
  __device__ __forceinline__ void read16(int word, uint64_t& lo, uint64_t& hi) const {
    uint32_t x[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) x[i] = w[word + i];
    uint32_t y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = __funnelshift_r(x[i], x[i + 1], sh);
    lo = (static_cast<uint64_t>(y[1]) << 32) | y[0];
    hi = (static_cast<uint64_t>(y[3]) << 32) | y[2];
  }
};

__device__ __forceinline__ void read16(const uint8_t* p, uint64_t& lo, uint64_t& hi) {
  Reader(p).read16(0, lo, hi);
}

// -- mbarriers (CTA scope) ----------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// arrive with release semantics: this thread's earlier shared-memory
// writes (and cp.async copies it has waited for) are visible to a thread
// whose wait sees the phase complete
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// wait until the phase with the given parity has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

}  // namespace ring
