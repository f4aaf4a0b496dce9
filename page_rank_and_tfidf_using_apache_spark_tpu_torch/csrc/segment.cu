// Deterministic CSR segmented sum:
//   out[r] = sum of v[e] for e in [ptr[r], ptr[r+1]), for r < n,
// where v[e] is w[src[e]] (* ew[e]) (the gather loader, spmv_impl='segment'
// and 'spark_exact') or x[e] (the value loader: the 'hybrid' head's row
// sums over head_row_node, 'sort_shuffle''s bucket sums over bucket_node).
// Float input is summed in double and rounded to float once a row; double
// input stays double.  The gather loader takes the product w[src[e]]*ew[e]
// in the input type before widening, as the plain version does.
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
// N = 872,513).  The gathers of w hit the 3.5 MB table in L2.
//
// Design (simple and right first; wgmma, TMA and tuning wait):
//   1. Merge path (Merrill and Garland, SC'16): the n row ends and the E
//      values are one list of n + E items, ordered so that row r's values
//      come before its end.  Block b takes items [b*kBlockItems, +kBlockItems),
//      so a hub's segment spans many blocks and a run of empty rows costs
//      one item each, like a value.  Warps 0 and 1 find the block's first
//      and last (row, value) coordinates with a 32-way search of ptr.
//   2. The block stages its row ends and its values (gathered, coalesced
//      over src) in shared memory.  Each thread finds its own coordinate in
//      shared memory and walks kItems items in order: a value adds to its
//      running sum, a row end writes the row (the thread's first row end is
//      held back: earlier threads may hold part of that row).
//   3. The threads' trailing partial sums, keyed by row, go through a block
//      segmented scan of fixed shape (warp shuffles, then warp 0 over the
//      warp totals); each thread adds the partial its predecessors carried
//      into its first row.  The block writes the partial of the row it ends
//      in (its carry) and, when its first row began in an earlier block,
//      that row's partial too instead of the row.
//   4. A second kernel, one warp per block, finishes each row that began in
//      an earlier block: it adds the carries of the blocks before in a fixed
//      order (lane l takes blocks b-1-l, b-1-l-32, ..., then a butterfly),
//      then the block's own partial.
// Every addition is in an order fixed by ptr and the sizes alone, so two
// calls on one input give the same bits; nothing is added by atomics.  A
// call is the two kernels, with no memset: every block writes its slots.
// ptr must be a CSR over the E values (ptr[0] = 0, nondecreasing,
// ptr[n] = E) and src must lie inside w: neither is checked here.
//
// C interface (loaded with ctypes): device pointers (ew may be null), a
// cudaStream_t, and the cudaError_t of the launches as the return value.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                         // merge-path items a thread
constexpr int kBlockItems = kThreads * kItems;   // 2048 items a block

template <typename T>
struct LoadGather {
  const int* src;
  const T* w;
  const T* ew;
  __device__ T operator()(long long e) const {
    const T v = __ldg(w + src[e]);
    return ew != nullptr ? v * ew[e] : v;
  }
};

template <typename T>
struct LoadValues {
  const T* x;
  __device__ T operator()(long long e) const { return x[e]; }
};

// Per-block slots of the second pass.
struct Carry {
  int* key;           // the row the block ends in (n when it ends after row n-1)
  double* val;        // the block's partial sum of that row
  int* first_key;     // the block's first row where it began earlier and ends here, else -1
  double* first_val;  // the block's partial sum of that row
};

// The merge-path coordinate at diagonal d: the number x of row ends among
// the first d items, searched in [lo, hi].  Row end p comes before item
// d iff ptr[p + 1] + p + 1 <= d.  Called by a whole warp; each round probes
// 32 evenly spaced rows.
__device__ long long path_row(const int* __restrict__ ptr, long long lo, long long hi,
                              long long d) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + lane * step;
    const bool before = p < hi && ptr[p + 1] + p + 1 <= d;
    const int c = __popc(__ballot_sync(0xffffffffu, before));  // probes 0..c-1 come before
    if (c == 0) {
      hi = lo;
    } else {
      const long long last = lo + (c - 1) * step;
      lo = last + 1;
      if (last + step < hi) hi = last + step;
    }
  }
  return lo;
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

template <typename T, typename Load>
__global__ void __launch_bounds__(kThreads)
segment_blocks(const int* __restrict__ ptr, Load load, T* __restrict__ out, int n, long long e,
               Carry carry) {
  __shared__ int s_end[kBlockItems + 1];  // ptr[x0 + 1 + k]: row x0 + k ends after value s_end[k]
  __shared__ T s_val[kBlockItems];        // the values [y0, y1)
  __shared__ long long s_x[2];
  __shared__ int s_split;
  __shared__ KeyVal s_last;
  __shared__ int s_first_key;
  __shared__ double s_first_val;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const long long total = n + e;
  const long long d0 = static_cast<long long>(blockIdx.x) * kBlockItems;
  const long long d1 = d0 + kBlockItems < total ? d0 + kBlockItems : total;
  if (warp < 2) {
    const long long d = warp == 0 ? d0 : d1;
    const long long lo = d - e > 0 ? d - e : 0;
    const long long hi = d < n ? d : n;
    const long long x = path_row(ptr, lo, hi, d);
    if ((tid & 31) == 0) {
      s_x[warp] = x;
      // the first row began in an earlier block: some of its values come
      // before d0 (x0 < n, since d0 < n + E)
      if (warp == 0) s_split = d0 - x > ptr[x];
    }
  }
  if (tid == 0) s_first_key = -1;
  __syncthreads();
  const long long x0 = s_x[0], x1 = s_x[1];
  const long long y0 = d0 - x0, y1 = d1 - x1;
  const int ends = static_cast<int>((x1 < n ? x1 : n - 1) - x0 + 1);
  for (int k = tid; k < ends; k += kThreads) s_end[k] = ptr[x0 + 1 + k];
  for (int k = tid; k < y1 - y0; k += kThreads) s_val[k] = load(y0 + k);
  __syncthreads();

  // this thread's coordinate, searched among the block's row ends
  long long d = d0 + static_cast<long long>(tid) * kItems;
  if (d > d1) d = d1;
  long long lo = d - e > x0 ? d - e : x0;
  long long hi = d < x1 ? d : x1;
  while (lo < hi) {
    const long long p = (lo + hi) >> 1;
    if (s_end[p - x0] + p + 1 <= d) lo = p + 1; else hi = p;
  }
  const int first_row = static_cast<int>(lo);
  int x = first_row;
  long long y = d - lo;
  const long long dend = d + kItems < d1 ? d + kItems : d1;
  double acc = 0.0, first = 0.0;
  bool ended = false;
  for (long long k = d; k < dend; ++k) {
    if (y < s_end[x - x0]) {
      acc += static_cast<double>(s_val[y - y0]);
      ++y;
    } else {
      if (ended) {
        out[x] = static_cast<T>(acc);
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
    if (first_row == x0 && s_split) {
      s_first_key = first_row;
      s_first_val = v;
    } else {
      out[first_row] = static_cast<T>(v);
    }
  }
  __syncthreads();
  if (tid == 0) {
    carry.key[blockIdx.x] = s_last.key;
    carry.val[blockIdx.x] = s_last.val;
    carry.first_key[blockIdx.x] = s_first_key;
    carry.first_val[blockIdx.x] = s_first_key >= 0 ? s_first_val : 0.0;
  }
}

// One warp per block b: the row that began before block b and ends in it
// gets the carries of the blocks before, in a fixed order, then b's part.
template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_fixup(Carry carry, T* __restrict__ out, int blocks) {
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= blocks) return;
  const int r = carry.first_key[b];
  if (r < 0) return;
  double part = 0.0;
  for (int base = b - 1;; base -= 32) {
    const int bb = base - lane;
    const bool mine = bb >= 0 && carry.key[bb] == r;
    if (mine) part += carry.val[bb];
    if (__ballot_sync(0xffffffffu, mine) != 0xffffffffu) break;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) out[r] = static_cast<T>(part + carry.first_val[b]);
}

inline long long blocks_for(long long n, long long e) {
  return (n + e + kBlockItems - 1) / kBlockItems;
}

inline long long align256(long long b) { return (b + 255) / 256 * 256; }

inline Carry carry_at(void* scratch, long long blocks) {
  char* p = static_cast<char*>(scratch);
  const long long ints = align256(blocks * static_cast<long long>(sizeof(int)));
  const long long dbls = align256(blocks * static_cast<long long>(sizeof(double)));
  return {reinterpret_cast<int*>(p), reinterpret_cast<double*>(p + ints),
          reinterpret_cast<int*>(p + ints + dbls),
          reinterpret_cast<double*>(p + 2 * ints + dbls)};
}

template <typename T, typename Load>
int segment_launch(const int* ptr, Load load, T* out, void* scratch, long long n, long long e,
                   cudaStream_t stream) {
  if (e < 0 || n < 0 || n >= INT_MAX || e >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  if (e == 0) return static_cast<int>(cudaMemsetAsync(out, 0, n * sizeof(T), stream));
  const long long blocks = blocks_for(n, e);
  const Carry carry = carry_at(scratch, blocks);
  segment_blocks<T, Load><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      ptr, load, out, static_cast<int>(n), e, carry);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned fix_blocks = static_cast<unsigned>((blocks + kWarps - 1) / kWarps);
  segment_fixup<T><<<fix_blocks, kThreads, 0, stream>>>(carry, out, static_cast<int>(blocks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of scratch a call over n rows and e values needs: four slots a
// block (two int, two double).
long long segment_scratch_len(long long n, long long e) {
  if (n <= 0 || e <= 0) return 0;
  const long long blocks = blocks_for(n, e);
  return 2 * align256(blocks * static_cast<long long>(sizeof(int))) +
         2 * align256(blocks * static_cast<long long>(sizeof(double)));
}

// Merge-path items (row ends and values) a block takes.
int segment_block_items() { return kBlockItems; }

int segment_gather_f32(const void* src, const void* w, const void* ew, const void* ptr,
                       void* out, void* scratch, long long n, long long e, void* stream) {
  const LoadGather<float> load{static_cast<const int*>(src), static_cast<const float*>(w),
                               static_cast<const float*>(ew)};
  return segment_launch(static_cast<const int*>(ptr), load, static_cast<float*>(out), scratch,
                        n, e, static_cast<cudaStream_t>(stream));
}

int segment_gather_f64(const void* src, const void* w, const void* ew, const void* ptr,
                       void* out, void* scratch, long long n, long long e, void* stream) {
  const LoadGather<double> load{static_cast<const int*>(src), static_cast<const double*>(w),
                                static_cast<const double*>(ew)};
  return segment_launch(static_cast<const int*>(ptr), load, static_cast<double*>(out), scratch,
                        n, e, static_cast<cudaStream_t>(stream));
}

int segment_values_f32(const void* x, const void* ptr, void* out, void* scratch, long long n,
                       long long e, void* stream) {
  const LoadValues<float> load{static_cast<const float*>(x)};
  return segment_launch(static_cast<const int*>(ptr), load, static_cast<float*>(out), scratch,
                        n, e, static_cast<cudaStream_t>(stream));
}

int segment_values_f64(const void* x, const void* ptr, void* out, void* scratch, long long n,
                       long long e, void* stream) {
  const LoadValues<double> load{static_cast<const double*>(x)};
  return segment_launch(static_cast<const int*>(ptr), load, static_cast<double*>(out), scratch,
                        n, e, static_cast<cudaStream_t>(stream));
}

const char* segment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
