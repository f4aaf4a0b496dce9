// A graph's derived device fields and kernel plans, built on the card from
// the arrays the host graph holds (ops/put_kernels.py; ops/pagerank.put_graph
// on a CUDA device).
//
// Replaces no TPU kernel: the JAX package builds these on the host in numpy
// and copies each to the device (ops/pagerank.py put_graph there).  The port's
// put copies only the edge sources, the int64 CSR pointers and the node
// normaliser (the int32 out-degree, or the float64 out-strength of a weighted
// graph), narrows the pointers to int32 with PyTorch's cast, and derives the
// rest here from those, bit for bit as the numpy builders do:
//   - put_spmv_rows: spmv.cu's plan, the first pointer of each tile of edges
//     (numpy: ops/pallas_kernels.spmv_rows);
//   - put_expand_dst: the destination of every dst-sorted edge, r for the
//     edges in [ptr[r], ptr[r+1]), a block a tile of put_spmv_rows;
//   - put_segment_coords: segment.cu's plan, the merge-path coordinate of
//     each tile (numpy: ops/segment_kernels.segment_coords);
//   - put_node_vectors_*: 1/s in double, 0 where s == 0, rounded to the
//     run's type once (IEEE division and a round-to-nearest cast, as numpy's
//     divide and astype), the float64 dangling mask (1 where s == 0) and the
//     has-outlinks mask (1 where s > 0) in the run's type.
//
// Bound on the H100: bytes.  At soc-LiveJournal1 (4.85M nodes, 69.0M edges)
// put_expand_dst writes 276 MB of dst and reads the pointers a tile spans
// (82 us at 3.35 TB/s); the node vectors read 19 MB and write 78 MB in
// float32 (29 us); the plans write under 0.2 MB.
//
// Design: no kernel needs another pass's result but the pointers and, in
// put_expand_dst, the tiles' first pointers.  A plan's entry is one thread's
// binary search over the int32 pointers (tens of thousands of tiles, all in
// one wave).  put_expand_dst's block takes a tile of edges whose rows lie in
// [rows[t], rows[t+1]] by the spmv plan; it stages those pointers in shared
// memory where they fit, and each edge's row is a binary search among them,
// neighbouring threads on neighbouring edges, so the dst stores coalesce.
// A tile whose edges span more rows than fit searches them in global memory.
// The searches run in 32-bit arithmetic: in 64-bit, put_expand_dst took
// 2.4 times as long.
//
// What holds it back (H100, PERF.md section 6): put_expand_dst's binary
// searches, instructions rather than bytes, about 2.8 times its bound at
// soc-LiveJournal1; the whole derivation is a third of a millisecond a put,
// behind the put's 35-60 ms of pageable copies.
//
// C interface (loaded with ctypes): device pointers, a cudaStream_t, and
// the cudaError_t of the launch as the return value (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 4096;  // pointers a block of put_expand_dst stages in shared memory

unsigned blocks_for(long long items) {
  return static_cast<unsigned>((items + kThreads - 1) / kThreads);
}

// The first j in [lo, hi) with ptr[j] > v, or hi (ptr nondecreasing there).
// Indices and values are below 2^31 (the wrappers check n and e), so the
// search runs in 32-bit arithmetic.
__device__ __forceinline__ int first_above(const int* ptr, int lo, int hi, int v) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (ptr[mid] <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// rows[t] = the number of pointers <= t*tile for 0 < t < tiles; rows[0] = 0
// and rows[tiles] = n + 1.
__global__ void __launch_bounds__(kThreads)
spmv_rows(const int* __restrict__ ptr, int* __restrict__ rows, long long n, long long tiles,
          long long tile) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t > tiles) return;
  long long r = 0;
  if (t == tiles && tiles > 0) {
    r = n + 1;
  } else if (t > 0) {
    r = first_above(ptr, 0, static_cast<int>(n + 1), static_cast<int>(t * tile));
  }
  rows[t] = static_cast<int>(r);
}

// Block t writes dst for edges [t*tile, min((t+1)*tile, e)).  Edge i's row
// is j - 1, j the first pointer index with ptr[j] > i; for the tile's edges
// j lies in [rows[t], rows[t+1]] (ptr[rows[t+1]] > (t+1)*tile, or
// rows[t+1] = n + 1 and ptr[n] = e), so the search runs over
// [rows[t], rows[t+1]) and ends at rows[t+1] where no pointer there is above i.
__global__ void __launch_bounds__(kThreads)
expand_dst(const int* __restrict__ ptr, const int* __restrict__ rows, int* __restrict__ dst,
           long long e, long long tile) {
  __shared__ int staged[kStage];
  const long long first = static_cast<long long>(blockIdx.x) * tile;
  const long long end = min(first + tile, e);
  const int lo = rows[blockIdx.x];
  const int hi = rows[blockIdx.x + 1];
  const int count = hi - lo;
  const bool in_shared = count <= kStage;
  if (in_shared) {
    for (int k = threadIdx.x; k < count; k += kThreads) staged[k] = ptr[lo + k];
  }
  __syncthreads();
  for (long long i = first + threadIdx.x; i < end; i += kThreads) {
    const int v = static_cast<int>(i);
    const int j = in_shared ? lo + first_above(staged, 0, count, v) : first_above(ptr, lo, hi, v);
    dst[i] = j - 1;
  }
}

// coords[b] = the number of rows p < n with ptr[p+1] + p + 1 <= min(b*items, n + e):
// the row ends among the first items of tile b's start (keys rise strictly).
__global__ void __launch_bounds__(kThreads)
segment_coords(const int* __restrict__ ptr, int* __restrict__ coords, long long n, long long e,
               long long tiles, long long items) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (b > tiles) return;
  const long long d = min(b * items, n + e);
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (ptr[mid + 1] + mid + 1 <= d) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  coords[b] = static_cast<int>(lo);
}

template <typename S, typename T>
__global__ void __launch_bounds__(kThreads)
node_vectors(const S* __restrict__ norm, T* __restrict__ inv, double* __restrict__ dangling,
             T* __restrict__ has, long long n) {
  const long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (v >= n) return;
  const double s = static_cast<double>(norm[v]);
  const bool out = s > 0.0;
  inv[v] = out ? static_cast<T>(1.0 / s) : static_cast<T>(0);
  dangling[v] = out ? 0.0 : 1.0;
  has[v] = out ? static_cast<T>(1) : static_cast<T>(0);
}

template <typename S, typename T>
int node_vectors_launch(const void* norm, void* inv, void* dangling, void* has, long long n,
                        void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  node_vectors<S, T><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(norm), static_cast<T*>(inv), static_cast<double*>(dangling),
      static_cast<T*>(has), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows [tiles + 1] of the int32 pointers ptr [n + 1], tiles of `tile` edges.
int put_spmv_rows(const void* ptr, void* rows, long long n, long long tiles, long long tile,
                  void* stream) {
  if (n < 0 || tiles < 0 || tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  spmv_rows<<<blocks_for(tiles + 1), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ptr), static_cast<int*>(rows), n, tiles, tile);
  return static_cast<int>(cudaGetLastError());
}

// dst [e] of the int32 pointers, given their spmv rows at the same `tile`.
int put_expand_dst(const void* ptr, const void* rows, void* dst, long long e, long long tile,
                   void* stream) {
  if (e < 0 || tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (e == 0) return 0;
  const long long tiles = (e + tile - 1) / tile;
  expand_dst<<<static_cast<unsigned>(tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ptr), static_cast<const int*>(rows), static_cast<int*>(dst), e,
      tile);
  return static_cast<int>(cudaGetLastError());
}

// coords [tiles + 1] of the int32 pointers ptr [n + 1] over e values, tiles of
// `items` merge-path items.
int put_segment_coords(const void* ptr, void* coords, long long n, long long e, long long tiles,
                       long long items, void* stream) {
  if (n < 0 || e < 0 || tiles < 0 || items < 1) return static_cast<int>(cudaErrorInvalidValue);
  segment_coords<<<blocks_for(tiles + 1), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ptr), static_cast<int*>(coords), n, e, tiles, items);
  return static_cast<int>(cudaGetLastError());
}

// The node vectors [n] of an int32 (i32) or float64 (f64) normaliser, in
// float32 or float64; the dangling mask in float64.
int put_node_vectors_i32_f32(const void* norm, void* inv, void* dangling, void* has, long long n,
                             void* stream) {
  return node_vectors_launch<int, float>(norm, inv, dangling, has, n, stream);
}

int put_node_vectors_i32_f64(const void* norm, void* inv, void* dangling, void* has, long long n,
                             void* stream) {
  return node_vectors_launch<int, double>(norm, inv, dangling, has, n, stream);
}

int put_node_vectors_f64_f32(const void* norm, void* inv, void* dangling, void* has, long long n,
                             void* stream) {
  return node_vectors_launch<double, float>(norm, inv, dangling, has, n, stream);
}

int put_node_vectors_f64_f64(const void* norm, void* inv, void* dangling, void* has, long long n,
                             void* stream) {
  return node_vectors_launch<double, double>(norm, inv, dangling, has, n, stream);
}

const char* put_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
