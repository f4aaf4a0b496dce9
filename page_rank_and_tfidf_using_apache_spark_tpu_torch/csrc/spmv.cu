// The prefix-sum SpMV of spmv_impl='pallas' as one fused scan kernel plus a
// row difference:
//   out[v] = sum over dst-sorted edges e of row v of w[src[e]] (* ew[e]).
//
// Replaces: page_rank_and_tfidf_using_apache_spark_tpu/ops/pallas_kernels.py
//   spmv_pallas (:144), which gathers w[src] and takes the CSR difference in
//   XLA around cumsum_pallas, because Mosaic's vector gather only takes
//   same-shape lane gathers.  Hopper has no such limit, so the gather, the
//   scan and the row ends are one kernel here.  In PyTorch the composite was
//   about a dozen launches a call, among them copies that widen the int32
//   src and indptr to int64 for indexing; this file reads both as int32.
//
// Bound on the H100: bytes.  src 4E, w 4N, indptr 4(N+1) and out 4N in
// float32: 24.7 MB, 7.4 us at 3.35 TB/s for the main path (E = 3,563,796,
// N = 872,513).  The gathers of w hit the 3.5 MB table in L2.  The design
// also writes and reads the row-end sums S, 4(N+1) bytes each way.
//
// Design, per tile of 4096 edges [e0, e1) (scan.cuh):
//   1. gather w[src[e]] through the read-only path, times ew[e] if given,
//      one edge a thread at a time (16-byte loads of src measured slower
//      with the L2 flushed on the H100: PERF.md §6);
//   2. scan the tile and run the deterministic fixed-window look-back, so
//      shared memory holds c0[j] = sum of the first j per-edge values for
//      j in (e0, e1];
//   3. while warp 0 looks back, warps 1 and 2 find the CSR pointers that
//      fall in this tile, [i0, i1), each with a 32-way search of indptr
//      (about 5 rounds of 32 parallel reads at N = 872,513);
//   4. S[i] = c0[indptr[i]] for every i in [i0, i1): indptr[i] in (e0, e1];
//      tile 0 also takes indptr[i] == 0, and the last tile's e1 is E, so
//      trailing empty rows are covered.  Knowing both ends lets the loop
//      keep several indptr loads in flight: a loop that stops at the first
//      pointer past e1 measured slower (PERF.md §6).
// A second small kernel writes out[v] = S[v+1] - S[v]: the same value as the
// plain c0[indptr[v+1]] - c0[indptr[v]].  A call is one cudaMemsetAsync of
// the tile descriptors, the scan kernel and the difference kernel.  Two
// calls on one input give the same bits.  indptr must be a CSR over the E
// edges (nondecreasing, in [0, E]) and src must lie in [0, N): neither is
// checked here.
//
// C interface (loaded with ctypes): device pointers (ew may be null), a
// cudaStream_t, and the cudaError_t of the launches as the return value.

#include <cuda_runtime.h>

#include <climits>

#include "scan.cuh"

namespace {

template <typename T>
struct LoadEdge {
  static constexpr bool kVec = false;
  const int* src;
  const T* w;
  const T* ew;
  __device__ T one(long long e) const {
    const T v = __ldg(w + src[e]);
    return ew != nullptr ? v * ew[e] : v;
  }
};

// The first index i of the nondecreasing a[0, n) with a[i] > key, or n.
// Called by a whole warp; each round probes 32 evenly spaced entries.
__device__ int first_greater(const int* __restrict__ a, int n, long long key) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + lane * step;
    const bool below = p < hi && a[p] <= key;
    const int c = __popc(__ballot_sync(0xffffffffu, below));  // probes 0..c-1 are <= key
    if (c == 0) {
      hi = lo;
    } else {
      const long long last = lo + (c - 1) * step;
      lo = last + 1;
      if (last + step < hi) hi = last + step;
    }
  }
  return static_cast<int>(lo);
}

// Warps 1 and 2: the first CSR pointers past lo and past hi, into rows[0]
// and rows[1] (shared memory).
struct FindRows {
  const int* indptr;
  int entries;
  long long lo, hi;
  int* rows;
  __device__ void operator()() const {
    const int warp = threadIdx.x >> 5;
    if (warp == 1 || warp == 2) {
      const int r = first_greater(indptr, entries, warp == 1 ? lo : hi);
      if ((threadIdx.x & 31) == 0) rows[warp - 1] = r;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(scan::kThreads)
spmv_scan(const int* __restrict__ src, const int* __restrict__ indptr, const T* __restrict__ w,
          const T* __restrict__ ew, T* __restrict__ sums, long long e, int n,
          scan::TileState st) {
  __shared__ T tile[scan::kSmem];
  __shared__ int rows[2];
  const int t = scan::take_ticket(st);
  const long long base = static_cast<long long>(t) * scan::kTile;
  const int count = e - base < scan::kTile ? static_cast<int>(e - base) : scan::kTile;
  const long long end = base + count;
  const T excl = scan::scan_tile(tile, st, t, base, count, LoadEdge<T>{src, w, ew},
                                 FindRows{indptr, n + 1, t == 0 ? -1LL : base, end, rows});
#pragma unroll 4
  for (int i = rows[0] + threadIdx.x; i < rows[1]; i += scan::kThreads) {
    const long long j = indptr[i];
    sums[i] = j == base ? excl : tile[scan::padded(static_cast<int>(j - 1 - base))];
  }
}

template <typename T>
__global__ void __launch_bounds__(scan::kThreads)
row_diff(const T* __restrict__ sums, T* __restrict__ out, int n) {
  const int v = blockIdx.x * scan::kThreads + threadIdx.x;
  if (v < n) out[v] = sums[v + 1] - sums[v];
}

inline long long align256(long long b) { return (b + 255) / 256 * 256; }

template <typename T>
int spmv_launch(const int* src, const int* indptr, const T* w, const T* ew, T* out,
                void* scratch, long long e, long long n, cudaStream_t stream) {
  if (e < 0 || n < 0 || n >= INT_MAX || e > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  if (e == 0) return static_cast<int>(cudaMemsetAsync(out, 0, n * sizeof(T), stream));
  const long long tiles = scan::tiles_for(e);
  const long long state = scan::state_bytes(tiles);
  T* sums = reinterpret_cast<T*>(static_cast<char*>(scratch) + align256(state));
  cudaError_t err = cudaMemsetAsync(scratch, 0, state, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  spmv_scan<T><<<static_cast<unsigned>(tiles), scan::kThreads, 0, stream>>>(
      src, indptr, w, ew, sums, e, static_cast<int>(n), scan::state_at(scratch, tiles));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n + scan::kThreads - 1) / scan::kThreads);
  row_diff<T><<<blocks, scan::kThreads, 0, stream>>>(sums, out, static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of scratch a call on e edges and n rows needs, for elements of
// elem_bytes: the tile descriptors, then the n + 1 row-end sums.
long long spmv_scratch_len(long long e, long long n, int elem_bytes) {
  if (e <= 0 || n <= 0) return 0;
  return align256(scan::state_bytes(scan::tiles_for(e))) + (n + 1) * elem_bytes;
}

// Edges per tile of the scan.
int spmv_tile_len() { return scan::kTile; }

int spmv_f32(const void* src, const void* indptr, const void* w, const void* ew, void* out,
             void* scratch, long long e, long long n, void* stream) {
  return spmv_launch(static_cast<const int*>(src), static_cast<const int*>(indptr),
                     static_cast<const float*>(w), static_cast<const float*>(ew),
                     static_cast<float*>(out), scratch, e, n, static_cast<cudaStream_t>(stream));
}

int spmv_f64(const void* src, const void* indptr, const void* w, const void* ew, void* out,
             void* scratch, long long e, long long n, void* stream) {
  return spmv_launch(static_cast<const int*>(src), static_cast<const int*>(indptr),
                     static_cast<const double*>(w), static_cast<const double*>(ew),
                     static_cast<double*>(out), scratch, e, n, static_cast<cudaStream_t>(stream));
}

const char* spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
