// Device side of a per-graph plan, shared by segment.cu and spmv.cu.
//
// A plan (ops/segment_kernels.py, ops/pallas_kernels.py) is built once per
// graph.  It holds the graph's partition into tiles, computed on the host,
// and the scratch of every call: a CallState and one slot or a few a tile,
// allocated and zeroed once.  No call clears the scratch: each call flags
// its slots with an epoch of its own, so a slot of an earlier call (or the
// zeroed scratch, epoch 0) never reads as published.
//   - A kernel with one block a tile (spmv.cu) never resets its ticket
//     counter: call k takes tickets [k*tiles, (k+1)*tiles), so a block's
//     ticket gives both its tile and the call's epoch k + 1.
//   - A kernel with persistent blocks (segment.cu) reads the epoch the
//     previous call left and uses the next one; the last block to finish
//     resets the ticket and done counters and stores the call's epoch.
// So calls on one plan must follow each other on one stream; a plan serves
// one stream at a time.  An epoch repeats after 2^32 - 1 calls, long after
// every slot of that call was written again.
//
// Tiles are taken in ticket order (atomicAdd on the CallState), not by
// blockIdx.x: a block waits only on tiles whose tickets were handed out
// before its own, so every tile it waits on is resident or finished, and a
// wait never deadlocks, whatever order the hardware schedules blocks in.
// A wait that outlasts kSpinLimit polls (seconds) traps, so a fault shows
// as a launch error rather than a hung card.
//
// Also here: the TMA bulk copy of a slice of global memory into shared
// memory, completing on an mbarrier.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace plan {

struct CallState {
  unsigned long long ticket;  // tickets handed out
  unsigned int done;          // persistent blocks finished in this call
  unsigned int epoch;         // the epoch of the last call that finished (persistent)
};

constexpr unsigned int kSpinLimit = 1u << 22;

// The epoch after e: 1 .. 2^32 - 1, never 0.
__device__ __forceinline__ unsigned int next_epoch(unsigned long long e) {
  return static_cast<unsigned int>(e % 0xffffffffull) + 1u;
}

// Persistent blocks: the epoch of this call.  Every block reads the same
// value: it changes only when the call's last block finishes, after every
// block has started.
__device__ __forceinline__ unsigned int call_epoch(const CallState* cs) {
  return next_epoch(*reinterpret_cast<const volatile unsigned int*>(&cs->epoch));
}

// Thread 0 only: the next ticket.
__device__ __forceinline__ unsigned long long take_ticket(CallState* cs) {
  return atomicAdd(&cs->ticket, 1ull);
}

// Persistent blocks: called by every thread of a block that takes no more
// tiles; the last block of the call leaves the counters at zero and the
// call's epoch for the next call.
__device__ __forceinline__ void finish_call(CallState* cs, unsigned int epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&cs->done, 1u) == gridDim.x - 1) {
      atomicExch(&cs->ticket, 0ull);
      atomicExch(&cs->done, 0u);
      atomicExch(&cs->epoch, epoch);
    }
  }
}

// A published value of one call: in float, the value's bits and the epoch
// share one 64-bit word, written and read with one volatile access; in
// double, the value is written, then __threadfence(), then the epoch, and a
// reader reads the epoch, fences, then the value.
struct Slot {
  unsigned long long word;
  unsigned long long flag;  // double only
};

__device__ __forceinline__ void publish(Slot* s, float v, unsigned int epoch) {
  const unsigned long long w =
      (static_cast<unsigned long long>(epoch) << 32) | __float_as_uint(v);
  *reinterpret_cast<volatile unsigned long long*>(&s->word) = w;
}

__device__ __forceinline__ bool try_read(const Slot* s, float* v, unsigned int epoch) {
  const unsigned long long w = *reinterpret_cast<const volatile unsigned long long*>(&s->word);
  if (static_cast<unsigned int>(w >> 32) != epoch) return false;
  *v = __uint_as_float(static_cast<unsigned int>(w));
  return true;
}

__device__ __forceinline__ void publish(Slot* s, double v, unsigned int epoch) {
  *reinterpret_cast<volatile unsigned long long*>(&s->word) =
      static_cast<unsigned long long>(__double_as_longlong(v));
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(&s->flag) = epoch;
}

__device__ __forceinline__ bool try_read(const Slot* s, double* v, unsigned int epoch) {
  if (*reinterpret_cast<const volatile unsigned long long*>(&s->flag) != epoch) return false;
  __threadfence();
  *v = __longlong_as_double(
      static_cast<long long>(*reinterpret_cast<const volatile unsigned long long*>(&s->word)));
  return true;
}

// One thread: the value of slot s once it is published in this call.
template <typename T>
__device__ __forceinline__ T wait_read(const Slot* s, unsigned int epoch) {
  T v;
  for (unsigned int tries = 0; !try_read(s, &v, epoch); ++tries) {
    if (tries == kSpinLimit) __trap();
  }
  return v;
}

// ---- TMA bulk copies ----

__device__ __forceinline__ std::uint32_t smem_addr(const void* p) {
  return static_cast<std::uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(std::uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Thread 0: arm `bar` for `bytes` of copies in this phase.
__device__ __forceinline__ void barrier_expect(std::uint64_t* bar, std::uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Copy `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, std::uint32_t bytes,
                                          std::uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Wait for phase `parity` of `bar` to complete.
__device__ __forceinline__ void barrier_wait(std::uint64_t* bar, std::uint32_t parity) {
  for (std::uint32_t tries = 0;; ++tries) {
    std::uint32_t done = 0;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n" : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (tries == kSpinLimit) __trap();
  }
}

// The 16-byte aligned span of global memory that holds `count` elements of
// `size` bytes from `p`: its start, and its length in bytes.  The span
// reaches at most 12 bytes past either end of the slice, into the 16-byte
// chunks that hold the slice's ends; those lie inside the slice's
// allocation, whose base and size are multiples of 16 (CUDA allocations are
// 256-byte aligned, and PyTorch's caching allocator rounds sizes up to 512).
struct Span {
  const void* start;
  std::uint32_t bytes;
  int lead;  // elements of the span ahead of p
};

__device__ __forceinline__ Span span_of(const void* p, long long count, int size) {
  const auto a = reinterpret_cast<std::uintptr_t>(p);
  const std::uintptr_t lo = a & ~static_cast<std::uintptr_t>(15);
  const std::uintptr_t hi = (a + static_cast<std::uintptr_t>(count) * size + 15) &
                            ~static_cast<std::uintptr_t>(15);
  return {reinterpret_cast<const void*>(lo), static_cast<std::uint32_t>(hi - lo),
          static_cast<int>((a - lo) / size)};
}

}  // namespace plan
