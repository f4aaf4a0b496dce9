// Block-level pieces of a single-pass, deterministic prefix scan over tiles,
// shared by cumsum.cu and spmv.cu.
//
// A call scans its input in tiles of kTile elements, one block per tile.
// Each block takes its tile's index from an atomicAdd ticket, not from
// blockIdx.x: a block only ever waits on tiles whose tickets were handed
// out before its own, so every tile it waits on is resident or finished,
// whatever order the hardware schedules blocks in.
//
// Per tile (scan_tile):
//   1. load: kItems elements a thread into padded shared memory, one
//      element at a time, coalesced, with the ragged end masked, or, for a
//      loader that offers them, as 16-byte loads where the tile is full and
//      the pointer aligned;
//   2. each thread scans its kItems contiguous elements serially, and the
//      per-thread totals are scanned across the block with warp shuffles;
//   3. the tile publishes its aggregate A(t), then warp 0 looks back over a
//      fixed window of kWindow predecessors and publishes the tile's
//      inclusive prefix P(t);
//   4. the tile's global inclusive prefix goes back into shared memory.
//
// Determinism (two calls on one input give the same bits): the textbook
// decoupled look-back (Merrill and Garland, NVR-2016-002) adds aggregates up
// to the first inclusive prefix it finds, so its association depends on
// timing.  Here tile t always forms its exclusive prefix as
//   P(t - kWindow) + A(t - kWindow + 1) + ... + A(t - 1)
// with tiles below 0 read as 0: lane l of warp 0 sums its kPerLane window
// slots in order, and the 32 lane sums are reduced in a fixed butterfly.
// P(t) = that + A(t) has one association whatever the timing.  The serial
// chain is tiles / kWindow hops, 7 at the PageRank main path's 871 tiles.
//
// Descriptors: each tile owns two 16-byte slots, A(t) and P(t).  In float
// the value's bits and a flag share one 64-bit word, written and read with
// one volatile access.  In double the value is written, then
// __threadfence(), then the flag; a reader reads the flag, fences, then
// reads the value.  Every read is volatile, so no spin loop is hoisted.
// Slots and the ticket counter start at zero: the launcher clears them with
// one cudaMemsetAsync before the kernel (scratch from torch.empty holds
// garbage, and a per-call epoch could collide with it).

#pragma once

#include <cuda_runtime.h>

namespace scan {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // 4096 elements per block
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 4;
constexpr int kWindow = 32 * kPerLane;  // tiles read by one look-back
constexpr int kSmem = kTile + kTile / 32;  // padded tile in shared memory

// Shared-memory index with one pad word every 32, so that thread t reading
// element t*kItems+i and thread t writing element i*kThreads+t each hit 32
// different banks.
__device__ __forceinline__ int padded(int k) { return k + (k >> 5); }

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    T y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

// Butterfly sum: every lane ends with the same bits, since each step adds
// the same two values in either order.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Exclusive scan of one value per thread across the block.  Stores the
// block total in *total (shared) and returns this thread's exclusive prefix.
// Ends with a barrier.
template <typename T>
__device__ T block_exclusive_scan(T v, T* total) {
  __shared__ T warp_off[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T inc = warp_inclusive_scan(v);
  if (lane == 31) warp_off[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const T t = lane < kWarps ? warp_off[lane] : T(0);
    const T ti = warp_inclusive_scan(t);
    if (lane < kWarps) warp_off[lane] = ti - t;
    if (lane == kWarps - 1) *total = ti;
  }
  __syncthreads();
  const T out = inc - v + warp_off[warp];
  __syncthreads();
  return out;
}

// 16 bytes of T.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int kN = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int kN = 2;
};

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}
__device__ __forceinline__ double lane_of(const double2& v, int c) { return c == 0 ? v.x : v.y; }
__device__ __forceinline__ float4 pack(const float* v) {
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ double2 pack(const double* v) { return make_double2(v[0], v[1]); }

__device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

struct Slot {
  unsigned long long word;  // float: flag << 32 | value bits; double: value bits
  unsigned long long flag;  // double only
};

struct TileState {
  unsigned int* ticket;
  Slot* agg;  // A(t)
  Slot* inc;  // P(t)
};

inline long long tiles_for(long long n) { return (n + kTile - 1) / kTile; }

// Bytes of the ticket counter (padded to 16) and the descriptors.
inline long long state_bytes(long long tiles) {
  return 16 + 2 * tiles * static_cast<long long>(sizeof(Slot));
}

inline TileState state_at(void* scratch, long long tiles) {
  char* p = static_cast<char*>(scratch);
  Slot* slots = reinterpret_cast<Slot*>(p + 16);
  return {reinterpret_cast<unsigned int*>(p), slots, slots + tiles};
}

__device__ __forceinline__ void publish(Slot* s, float v) {
  const unsigned long long w = (1ull << 32) | __float_as_uint(v);
  *reinterpret_cast<volatile unsigned long long*>(&s->word) = w;
}

__device__ __forceinline__ bool try_read(const Slot* s, float* v) {
  const unsigned long long w = *reinterpret_cast<const volatile unsigned long long*>(&s->word);
  if ((w >> 32) == 0) return false;
  *v = __uint_as_float(static_cast<unsigned int>(w));
  return true;
}

__device__ __forceinline__ void publish(Slot* s, double v) {
  *reinterpret_cast<volatile unsigned long long*>(&s->word) =
      static_cast<unsigned long long>(__double_as_longlong(v));
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(&s->flag) = 1ull;
}

__device__ __forceinline__ bool try_read(const Slot* s, double* v) {
  if (*reinterpret_cast<const volatile unsigned long long*>(&s->flag) == 0) return false;
  __threadfence();
  *v = __longlong_as_double(
      static_cast<long long>(*reinterpret_cast<const volatile unsigned long long*>(&s->word)));
  return true;
}

// This block's tile index, in the order blocks start.
__device__ __forceinline__ int take_ticket(const TileState& st) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = static_cast<int>(atomicAdd(st.ticket, 1u));
  __syncthreads();
  return ticket;
}

// Warp 0 only: tile t's exclusive prefix from the fixed window.  Window slot
// j (lane j / kPerLane) is tile t - kWindow + j: its P for j == 0, its A
// otherwise, 0 below tile 0.  Each lane issues all its reads before it
// re-polls the ones not yet published.
template <typename T>
__device__ T lookback(const TileState& st, int t) {
  const int lane = threadIdx.x & 31;
  T val[kPerLane];
  bool ready[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    val[i] = T(0);
    ready[i] = t - kWindow + lane * kPerLane + i < 0;
  }
  bool done;
  do {
    done = true;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      if (!ready[i]) {
        const int j = lane * kPerLane + i;
        const int k = t - kWindow + j;
        ready[i] = try_read(j == 0 ? st.inc + k : st.agg + k, &val[i]);
        done = done && ready[i];
      }
    }
  } while (!__all_sync(0xffffffffu, done));
  T part = T(0);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) part += val[i];
  return warp_sum(part);
}

// Scans tile t, elements [base, base + count) with count in [1, kTile], into
// tile[] (kSmem elements of shared memory): afterwards tile[padded(k)] holds
// the global inclusive prefix through element base + k, for k < count.
// load.one(e) gives element e.  Where Load::kVec and load.vec_ok,
// load.vec(e) gives the Vec<T>::kN elements from e (a multiple of kN).
// Warps 1.. run side() while warp 0 looks back.  Returns the tile's
// exclusive prefix.  Ends with a barrier.
template <typename T, typename Load, typename Side>
__device__ T scan_tile(T* tile, const TileState& st, int t, long long base, int count,
                       const Load& load, const Side& side) {
  __shared__ T total;
  __shared__ T tile_excl;
  const int tid = threadIdx.x;
  bool loaded = false;
  if constexpr (Load::kVec) {
    if (count == kTile && load.vec_ok) {
      constexpr int V = Vec<T>::kN;
      typename Vec<T>::type x[kItems / V];
#pragma unroll
      for (int i = 0; i < kItems / V; ++i) x[i] = load.vec(base + (i * kThreads + tid) * V);
#pragma unroll
      for (int i = 0; i < kItems / V; ++i) {
#pragma unroll
        for (int c = 0; c < V; ++c) tile[padded((i * kThreads + tid) * V + c)] = lane_of(x[i], c);
      }
      loaded = true;
    }
  }
  if (!loaded) {
    T x[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int k = i * kThreads + tid;
      x[i] = k < count ? load.one(base + k) : T(0);
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) tile[padded(i * kThreads + tid)] = x[i];
  }
  __syncthreads();
  T v[kItems];
  T run = T(0);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    run += tile[padded(tid * kItems + i)];
    v[i] = run;
  }
  const T pre = block_exclusive_scan(run, &total);
  if (tid < 32) {
    if (tid == 0) publish(st.agg + t, total);
    const T excl = lookback<T>(st, t);
    if (tid == 0) {
      publish(st.inc + t, excl + total);
      tile_excl = excl;
    }
  } else {
    side();
  }
  __syncthreads();
  const T off = pre + tile_excl;
#pragma unroll
  for (int i = 0; i < kItems; ++i) tile[padded(tid * kItems + i)] = off + v[i];
  __syncthreads();
  return tile_excl;
}

struct NoSide {
  __device__ void operator()() const {}
};

}  // namespace scan
