// Deterministic CSR segmented sum:
//   out[r] = sum of v[e] for e in [ptr[r], ptr[r+1]), for r < n,
// where v[e] is w[src[e]] (* ew[e]) (the gather loader, spmv_impl='segment'
// and 'spark_exact') or x[e] (the value loader: the 'hybrid' head's row
// sums over head_row_node, 'sort_shuffle''s bucket sums over bucket_node).
// Float input is summed in double and rounded to float once a row; double
// input stays double.  The widened entries (segment_*_f32_f64) take float
// input and write each row's double sum without that rounding, for a caller
// that adds rows summed on several devices and rounds once after.  The
// gather loader takes the product w[src[e]]*ew[e] in the input type before
// widening, as the plain version does.
//
// Replaces: jax.ops.segment_sum(..., indices_are_sorted=True) at
//   page_rank_and_tfidf_using_apache_spark_tpu/ops/pagerank.py:378 (segment),
//   :508 (hybrid head) and :537 (sort_shuffle), which the JAX package leaves
//   to XLA.  The port's plain version, a float64 index_add_, adds through
//   atomics: their order changes from run to run, and on the main path they
//   serialise on the hub's segment (about a fifth of all edges).
//
// Bound on the H100: bytes.  For the main path, float32, unweighted: src 4E,
// ptr 4(N+1), w 4N and out 4N: 24.7 MB, 7.4 us at 3.35 TB/s (E = 3,563,796,
// N = 872,513).  The gathers of w hit the 3.5 MB table in L2.  There is
// about one addition per 4 bytes, so the limit is bytes in flight.  A
// widened entry writes 8 bytes a row where the float entry writes 4.
//
// Design:
//   1. Merge path (Merrill and Garland, SC'16): the n row ends and the E
//      values are one list of n + E items, ordered so that row r's values
//      come before its end.  Tile b takes items [b*kBlockItems, +kBlockItems),
//      so a hub's segment spans many tiles and a run of empty rows costs
//      one item each, like a value.  The plan (ops/segment_kernels.py,
//      built once per graph) holds each tile's first coordinate: the row
//      ends x before its first item, so its values start at y = d - x.
//   2. Persistent blocks, one wave of them, take tiles in ticket order.  As
//      soon as a block holds a tile, thread 0 starts two TMA bulk copies
//      into shared memory: the tile's slice of ptr and its slice of src
//      (gather loader) or of the values.  The gather loader then issues all
//      of a thread's kItems gathers of w from the staged src before it
//      stores any (a float takes its index's place).  A block takes its
//      next ticket only when its tile is done: with the split rows of (5)
//      finished at once, tickets taken while the tile before was walked
//      made the tiles after them wait, and a ring of two stages (tile i+1's
//      copies in flight while tile i is walked) measured slower, its
//      doubled shared memory also taking L1 from the gathers (PERF.md §6).
//   3. Each thread finds its own coordinate among the staged row ends and
//      walks kItems items in order: a value adds to its running sum, a row
//      end writes the row (the thread's first row end is held back: earlier
//      threads may hold part of that row).
//   4. The threads' trailing partial sums, keyed by row, go through a block
//      segmented scan of fixed shape (warp shuffles, then warp 0 over the
//      warp totals); each thread adds the partial its predecessors carried
//      into its first row.  The tile publishes its carry: the row it ends
//      in and its partial sum of that row, flagged with the call's epoch.
//   5. A row that began in an earlier tile and ends in tile b gets the
//      carries of the tiles before b, in a fixed order (lane l of a warp
//      takes tiles b-1-l, b-1-l-32, ..., then a butterfly), each read once
//      its flag shows, then b's own part.  The block puts such rows off to
//      its end, when the tiles before are done, and finishes them a warp
//      each (at once, past kPending of them).  Earlier tiles hold earlier
//      tickets, so a wait never deadlocks (csrc/plan.cuh).
// Every addition is in an order fixed by ptr and the sizes alone, so two
// calls on one input give the same bits; nothing is added by atomics.  A
// call is one kernel, with no memset: the plan's scratch was zeroed once,
// and each call flags its carries with a new epoch.  ptr must be a CSR over
// the E values (ptr[0] = 0, nondecreasing, ptr[n] = E), src must lie inside
// w, and the plan must be ptr's: none of this is checked here.
//
// C interface (loaded with ctypes): device pointers (ew may be null), a
// cudaStream_t, and the cudaError_t of the launch as the return value.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "plan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                        // merge-path items a thread
constexpr int kBlockItems = kThreads * kItems;  // 2048 items a tile
// At most 32 registers a thread, so 8 blocks fit an SM, as the 16.5 KB of
// shared memory a block of the float gather loader allows (PERF.md §6).
constexpr int kMinBlocks = 8;
constexpr int kPending = 16;  // split rows a block puts off to its end
constexpr int kAhead = 4;     // rounds of 32 carries a warp reads at once
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int align16(long long b) {
  return static_cast<int>((b + 15) / 16 * 16);
}
// A tile stages ptr[x0 .. min(x1, n - 1) + 1], at most kBlockItems + 2 ints,
// and at most kBlockItems elements of src or the values, each as a 16-byte
// aligned span (plan::span_of: up to 12 bytes more at either end).
constexpr int kEndBytes = align16(4 * (kBlockItems + 2) + 24);
template <typename In>
__host__ __device__ constexpr int in_bytes() {
  return align16(static_cast<long long>(sizeof(In)) * kBlockItems + 24);
}

// A tile's carry: the row it ends in (n when it ends after row n-1) and its
// partial sum of that row.  The value is written, then __threadfence(),
// then the tag: the call's epoch above the row.
struct Carry {
  double val;
  unsigned long long tag;  // epoch << 32 | row
};

__device__ __forceinline__ void publish_carry(Carry* c, int key, double val, unsigned int epoch) {
  *reinterpret_cast<volatile double*>(&c->val) = val;
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(&c->tag) =
      static_cast<unsigned long long>(epoch) << 32 | static_cast<unsigned int>(key);
}

struct KeyVal {
  int key;
  double val;
};

// Reduce-by-key of two neighbours, a before b.
__device__ __forceinline__ KeyVal combine(const KeyVal& a, const KeyVal& b) {
  return {b.key, a.key == b.key ? a.val + b.val : b.val};
}

__device__ __forceinline__ KeyVal shfl_up(const KeyVal& kv, int off) {
  return {__shfl_up_sync(0xffffffffu, kv.key, off), __shfl_up_sync(0xffffffffu, kv.val, off)};
}

// Segmented exclusive scan of one (row, partial) a thread across the block,
// in a fixed shape.  Thread 0 gets {-1, 0}.  Returns this thread's exclusive
// prefix; *last gets the inclusive value of the block's last thread.  Ends
// with a barrier.
__device__ KeyVal block_segmented_scan(KeyVal kv, KeyVal* last) {
  __shared__ KeyVal warp_tot[kWarps];
  __shared__ KeyVal warp_pre[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  KeyVal inc = kv;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const KeyVal o = shfl_up(inc, off);
    if (lane >= off) inc = combine(o, inc);
  }
  const KeyVal prev = shfl_up(inc, 1);
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    KeyVal t = lane < kWarps ? warp_tot[lane] : KeyVal{-1, 0.0};
    KeyVal ti = t;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const KeyVal o = shfl_up(ti, off);
      if (lane >= off) ti = combine(o, ti);
    }
    const KeyVal before = shfl_up(ti, 1);
    if (lane < kWarps) warp_pre[lane] = lane == 0 ? KeyVal{-1, 0.0} : before;
    if (lane == kWarps - 1) *last = ti;
  }
  __syncthreads();
  KeyVal out;
  if (lane == 0) {
    out = warp_pre[warp];
  } else {
    out = warp == 0 ? prev : combine(warp_pre[warp], prev);
  }
  __syncthreads();
  return out;
}

// T is the input's type, O the output's: T, or double for float input.
template <typename T, typename O>
struct Args {
  const int* src;     // gather loader: [E] indices into w; null for the value loader
  const T* w;         // gather loader: the table; value loader: the E values
  const T* ew;        // gather loader: optional [E] edge weights
  const int* ptr;     // [n + 1]
  const int* coords;  // [tiles + 1]: row ends before each tile's first item
  O* out;             // [n]
  plan::CallState* cs;
  Carry* carry;  // [tiles]
  int n;
  long long e;
  int tiles;
};

// What thread 0 tells the block about the tile it stages.
struct TileMeta {
  int t;             // the tile, or >= tiles when the block is done
  int x0, x1;        // it ends rows [x0, x1)
  long long y0, y1;  // it holds values [y0, y1)
  int end_lead;      // ptr[x0] is element end_lead of the staged ptr span
  int in_lead;       // src[y0] or x[y0] is element in_lead of the staged span
};

template <typename T, typename O, bool kGather>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
segment_tiles(Args<T, O> a) {
  using In = typename std::conditional<kGather, int, T>::type;
  // a float gathered from a staged src takes its index's place
  constexpr bool kInPlace = sizeof(T) == sizeof(In);
  extern __shared__ __align__(16) unsigned char smem[];
  auto* bar = reinterpret_cast<std::uint64_t*>(smem);
  int* s_ptr = reinterpret_cast<int*>(smem + 16);                // the ptr span
  unsigned char* s_in = smem + 16 + kEndBytes;                  // the src or values span
  T* s_wide = reinterpret_cast<T*>(s_in + in_bytes<In>());     // double gathers
  __shared__ TileMeta meta;
  __shared__ KeyVal s_last;
  __shared__ int s_first_key;
  __shared__ double s_first_val;
  // split rows whose carries are added after the block's last tile
  __shared__ int pend_tile[kPending], pend_row[kPending], pend_lo[kPending], s_pending;
  __shared__ double pend_part[kPending];

  const int tid = threadIdx.x;
  const long long total = a.n + a.e;
  const unsigned int epoch = plan::call_epoch(a.cs);
  const In* in_base;
  if constexpr (kGather) {
    in_base = a.src;
  } else {
    in_base = a.w;
  }

  // Thread 0: stage tile t, taken from the ticket counter.
  auto stage = [&](int t) {
    meta.t = t;
    if (t >= a.tiles) return;
    const long long d0 = static_cast<long long>(t) * kBlockItems;
    const long long d1 = d0 + kBlockItems < total ? d0 + kBlockItems : total;
    const int x0 = a.coords[t], x1 = a.coords[t + 1];
    const long long y0 = d0 - x0, y1 = d1 - x1;
    const int xe = (x1 < a.n ? x1 : a.n - 1) + 1;
    const plan::Span se = plan::span_of(a.ptr + x0, xe - x0 + 1, 4);
    const plan::Span sv = y1 > y0 ? plan::span_of(in_base + y0, y1 - y0, sizeof(In))
                                  : plan::Span{nullptr, 0, 0};
    plan::barrier_expect(bar, se.bytes + sv.bytes);
    plan::bulk_copy(s_ptr, se.start, se.bytes, bar);
    if (sv.bytes) plan::bulk_copy(s_in, sv.start, sv.bytes, bar);
    meta = {t, x0, x1, y0, y1, se.lead, sv.lead};
  };

  // One warp: row r began before tile t and ends in it with part `own`;
  // add the carries of the tiles before t in a fixed order (lane l takes
  // tiles t-1-l, t-1-l-32, ... while all 32 tiles of a round end in row r,
  // then a butterfly), then `own`.  Row r's first value lies in tile
  // (ptr[r] + r) / kBlockItems, so no tile below `lo`, the one before that,
  // ends in row r: each lane reads kAhead rounds of carries at once, all in
  // flight together, and adds them round by round as above.
  const int lane = tid & 31;
  auto finish_row = [&](int t, int r, double own, int lo) {
    double part = 0.0;
    for (int base = t - 1;; base -= 32 * kAhead) {
      unsigned long long tag[kAhead];
      double val[kAhead];
      bool ready[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) ready[j] = base - 32 * j - lane < lo;
      for (unsigned int tries = 0;; ++tries) {
        bool done = true;
#pragma unroll
        for (int j = 0; j < kAhead; ++j) {
          if (!ready[j]) {
            tag[j] = *reinterpret_cast<const volatile unsigned long long*>(
                &a.carry[base - 32 * j - lane].tag);
            ready[j] = static_cast<unsigned int>(tag[j] >> 32) == epoch;
            done = done && ready[j];
          }
        }
        if (done) break;
        if (tries == plan::kSpinLimit) __trap();
      }
      __threadfence();
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const int bb = base - 32 * j - lane;
        val[j] = bb >= lo ? *reinterpret_cast<const volatile double*>(&a.carry[bb].val) : 0.0;
      }
      bool more = true;
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const bool mine = base - 32 * j - lane >= lo && static_cast<int>(tag[j]) == r;
        if (mine) part += val[j];
        if (__ballot_sync(0xffffffffu, mine) != 0xffffffffu) {
          more = false;
          break;
        }
      }
      if (!more) break;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) a.out[r] = static_cast<O>(part + own);
  };

  if (tid == 0) {
    plan::barrier_init(bar);
    s_pending = 0;
    stage(static_cast<int>(plan::take_ticket(a.cs)));
  }
  __syncthreads();
  for (unsigned int phase = 0;; phase ^= 1u) {
    const TileMeta m = meta;
    if (m.t >= a.tiles) break;
    if (tid == 0) s_first_key = -1;
    plan::barrier_wait(bar, phase);
    const int* send = s_ptr + m.end_lead;  // send[k] = ptr[x0 + k]
    In* sin = reinterpret_cast<In*>(s_in) + m.in_lead;
    const long long d0 = static_cast<long long>(m.t) * kBlockItems;
    const long long d1 = d0 + kBlockItems < total ? d0 + kBlockItems : total;
    const long long x0 = m.x0, x1 = m.x1, y0 = m.y0;
    const T* vals;
    if constexpr (kGather) {
      // every gather of this thread in flight before any is stored
      const int count = static_cast<int>(m.y1 - y0);
      T* dst = kInPlace ? reinterpret_cast<T*>(sin) : s_wide;
      T v[kItems];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int k = i * kThreads + tid;
        if (k < count) {
          const T g = __ldg(a.w + sin[k]);
          v[i] = a.ew == nullptr ? g : g * __ldg(a.ew + y0 + k);
        }
      }
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int k = i * kThreads + tid;
        if (k < count) dst[k] = v[i];
      }
      __syncthreads();
      vals = dst;
    } else {
      vals = sin;
    }
    // the tile's first row began in an earlier tile: some of its values
    // come before d0 (x0 < n, since d0 < n + E)
    const bool split = y0 > send[0];

    // this thread's coordinate, searched among the tile's row ends
    long long d = d0 + static_cast<long long>(tid) * kItems;
    if (d > d1) d = d1;
    long long lo = d - a.e > x0 ? d - a.e : x0;
    long long hi = d < x1 ? d : x1;
    while (lo < hi) {
      const long long p = (lo + hi) >> 1;
      if (send[p - x0 + 1] + p + 1 <= d) lo = p + 1; else hi = p;
    }
    const int first_row = static_cast<int>(lo);
    int x = first_row;
    long long y = d - lo;
    const long long dend = d + kItems < d1 ? d + kItems : d1;
    double acc = 0.0, first = 0.0;
    bool ended = false;
    for (long long k = d; k < dend; ++k) {
      if (y < send[x - x0 + 1]) {
        acc += static_cast<double>(vals[y - y0]);
        ++y;
      } else {
        if (ended) {
          a.out[x] = static_cast<O>(acc);
        } else {
          first = acc;
          ended = true;
        }
        acc = 0.0;
        ++x;
      }
    }

    const KeyVal in = block_segmented_scan(KeyVal{x, acc}, &s_last);
    if (ended) {
      const double v = (tid > 0 ? in.val : 0.0) + first;
      if (first_row == x0 && split) {
        s_first_key = first_row;
        s_first_val = v;
      } else {
        a.out[first_row] = static_cast<O>(v);
      }
    }
    __syncthreads();
    if (tid < 32) {
      if (tid == 0) publish_carry(a.carry + m.t, s_last.key, s_last.val, epoch);
      // a row that began before this tile waits on the tiles before it: put
      // off to the block's end, when they are done, unless the list is full
      const int r = s_first_key;
      if (r >= 0) {
        const int k = s_pending;
        // the tile before the one that holds row r's first value, item
        // ptr[r] + r
        const int from = static_cast<int>((send[0] + x0) / kBlockItems) - 1;
        __syncwarp();
        if (k < kPending) {
          if (tid == 0) {
            pend_tile[k] = m.t;
            pend_row[k] = r;
            pend_lo[k] = from > 0 ? from : 0;
            pend_part[k] = s_first_val;
            s_pending = k + 1;
          }
        } else {
          finish_row(m.t, r, s_first_val, from > 0 ? from : 0);
        }
      }
    }
    // the staged spans are free: the next ticket, taken only now (2)
    __syncthreads();
    if (tid == 0) stage(static_cast<int>(plan::take_ticket(a.cs)));
    __syncthreads();
  }
  // the rows put off, a warp each
  for (int k = tid >> 5; k < s_pending; k += kWarps) {
    finish_row(pend_tile[k], pend_row[k], pend_part[k], pend_lo[k]);
  }
  plan::finish_call(a.cs, epoch);
}

inline long long tiles_for(long long n, long long e) {
  return (n + e + kBlockItems - 1) / kBlockItems;
}

// The plan's scratch: the CallState, then one Carry a tile.
inline long long state_len(long long tiles) {
  return static_cast<long long>(sizeof(plan::CallState)) +
         tiles * static_cast<long long>(sizeof(Carry));
}

template <typename T, typename O, bool kGather>
int segment_launch(Args<T, O> a, void* state, long long state_bytes, cudaStream_t stream) {
  if (a.e < 0 || a.n < 0 || a.n >= INT_MAX || a.e >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.n == 0) return 0;
  if (a.e == 0) return static_cast<int>(cudaMemsetAsync(a.out, 0, a.n * sizeof(O), stream));
  const long long tiles = tiles_for(a.n, a.e);
  if (state_bytes < state_len(tiles)) return static_cast<int>(cudaErrorInvalidValue);
  a.tiles = static_cast<int>(tiles);
  a.cs = static_cast<plan::CallState*>(state);
  a.carry = reinterpret_cast<Carry*>(static_cast<char*>(state) + sizeof(plan::CallState));
  using In = typename std::conditional<kGather, int, T>::type;
  const int smem = 16 + kEndBytes + in_bytes<In>() +
                   (sizeof(T) != sizeof(In) ? kBlockItems * static_cast<int>(sizeof(T)) : 0);
  auto kernel = segment_tiles<T, O, kGather>;
  // one wave of resident blocks, measured once per device
  static int resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    }
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = per_sm * sms;
  }
  const long long grid = resident[dev] < tiles ? resident[dev] : tiles;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O>
int gather(const void* src, const void* w, const void* ew, const void* ptr, const void* coords,
           void* out, void* state, long long state_bytes, long long n, long long e,
           void* stream) {
  Args<T, O> a{static_cast<const int*>(src), static_cast<const T*>(w),
               static_cast<const T*>(ew), static_cast<const int*>(ptr),
               static_cast<const int*>(coords), static_cast<O*>(out), nullptr, nullptr,
               static_cast<int>(n), e, 0};
  return segment_launch<T, O, true>(a, state, state_bytes, static_cast<cudaStream_t>(stream));
}

template <typename T, typename O>
int values(const void* x, const void* ptr, const void* coords, void* out, void* state,
           long long state_bytes, long long n, long long e, void* stream) {
  Args<T, O> a{nullptr, static_cast<const T*>(x), nullptr, static_cast<const int*>(ptr),
               static_cast<const int*>(coords), static_cast<O*>(out), nullptr, nullptr,
               static_cast<int>(n), e, 0};
  return segment_launch<T, O, false>(a, state, state_bytes, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Bytes of the plan's scratch for n rows and e values: the call state and
// one carry slot a tile.
long long segment_scratch_len(long long n, long long e) {
  if (n <= 0 || e <= 0) return 0;
  return state_len(tiles_for(n, e));
}

// Merge-path items (row ends and values) a tile takes.
int segment_block_items() { return kBlockItems; }

// coords: the plan's int32 [tiles + 1] first coordinates; state: its
// scratch of state_bytes, zeroed when the plan was built.
int segment_gather_f32(const void* src, const void* w, const void* ew, const void* ptr,
                       const void* coords, void* out, void* state, long long state_bytes,
                       long long n, long long e, void* stream) {
  return gather<float, float>(src, w, ew, ptr, coords, out, state, state_bytes, n, e, stream);
}

int segment_gather_f64(const void* src, const void* w, const void* ew, const void* ptr,
                       const void* coords, void* out, void* state, long long state_bytes,
                       long long n, long long e, void* stream) {
  return gather<double, double>(src, w, ew, ptr, coords, out, state, state_bytes, n, e, stream);
}

// Float input, each row's double sum written as it is: out is double [n].
int segment_gather_f32_f64(const void* src, const void* w, const void* ew, const void* ptr,
                           const void* coords, void* out, void* state, long long state_bytes,
                           long long n, long long e, void* stream) {
  return gather<float, double>(src, w, ew, ptr, coords, out, state, state_bytes, n, e, stream);
}

int segment_values_f32(const void* x, const void* ptr, const void* coords, void* out,
                       void* state, long long state_bytes, long long n, long long e,
                       void* stream) {
  return values<float, float>(x, ptr, coords, out, state, state_bytes, n, e, stream);
}

int segment_values_f64(const void* x, const void* ptr, const void* coords, void* out,
                       void* state, long long state_bytes, long long n, long long e,
                       void* stream) {
  return values<double, double>(x, ptr, coords, out, state, state_bytes, n, e, stream);
}

int segment_values_f32_f64(const void* x, const void* ptr, const void* coords, void* out,
                           void* state, long long state_bytes, long long n, long long e,
                           void* stream) {
  return values<float, double>(x, ptr, coords, out, state, state_bytes, n, e, stream);
}

const char* segment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
