// The prefix-sum SpMV of spmv_impl='pallas' as one fused kernel:
//   out[v] = sum over dst-sorted edges e of row v of w[src[e]] (* ew[e]),
// computed as c0[indptr[v+1]] - c0[indptr[v]] over the deterministic prefix
// sum c0 of the per-edge values (c0[0] = 0).
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
// N = 872,513).  The gathers of w hit the 3.5 MB table in L2.
//
// Design, per tile of 4096 edges [base, end) (the shape of scan.cuh):
//   1. the plan (ops/pallas_kernels.py, built once per graph) gives the
//      tile's CSR pointers [i0, i1), those with indptr[i] in (base, end]
//      (tile 0 also takes indptr[i] == 0, and the last tile's end is E, so
//      trailing empty rows are covered); the block reads them before it
//      loads anything, so no search of indptr runs on a call;
//   2. gather w[src[e]] through the read-only path, times ew[e] if given,
//      kItems a thread, all in flight before any is stored;
//   3. scan the tile and run the deterministic fixed-window look-back, so
//      shared memory holds c0[j] for j in (base, end]: the association is
//      scan.cuh's, so c0 has the bits cumsum.cu gives;
//   4. out[v] for every row whose end pointer indptr[v+1] falls in the tile:
//      c0 at the row's start comes from shared memory when the start pointer
//      falls in the tile too; otherwise the row began in the earlier tile
//      t_s = (indptr[v] - 1) / kTile (c0[0] = 0 needs no tile), and the
//      pointer indptr[v] is t_s's last pointer.  Each tile publishes c0 at
//      its last pointer beside its A(t) and P(t), as soon as its look-back
//      ends, and such a row reads it from t_s's descriptor: no chain runs
//      through a hub's tiles.  That row is written last, so its wait holds
//      up no other row of the tile.
// The arithmetic is the plain c0[end] - c0[start] in T, so the result has
// the bits of scan.cuh's c0 differenced, and two calls on one input give
// the same bits.  A call is one kernel: no memset and no second kernel.  The
// descriptors live in the plan's scratch, zeroed once and flagged with each
// call's epoch (csrc/plan.cuh).  indptr must be a CSR over the E edges
// (nondecreasing, in [0, E]), src must lie in [0, N), and the plan must be
// indptr's: none of this is checked here.
//
// C interface (loaded with ctypes): device pointers (ew may be null), a
// cudaStream_t, and the cudaError_t of the launch as the return value.

#include <cuda_runtime.h>

#include <climits>

#include "plan.cuh"
#include "scan.cuh"

namespace {

using plan::Slot;

template <typename T>
struct LoadEdge {
  const int* src;
  const T* w;
  const T* ew;
  __device__ T one(long long e) const {
    const T v = __ldg(w + src[e]);
    return ew != nullptr ? v * ew[e] : v;
  }
};

// The plan's scratch after the call state: three descriptors a tile.
struct Tiles {
  Slot* agg;   // A(t), the tile's sum
  Slot* inc;   // P(t), its inclusive prefix
  Slot* last;  // c0 at its last CSR pointer
};

// Warp 0 only: tile t's exclusive prefix from the fixed window, as
// scan.cuh's lookback: window slot j (lane j / kPerLane) is tile
// t - kWindow + j, its P for j == 0, its A otherwise, 0 below tile 0.
template <typename T>
__device__ T lookback(const Tiles& st, int t, unsigned int epoch) {
  const int lane = threadIdx.x & 31;
  T val[scan::kPerLane];
  bool ready[scan::kPerLane];
#pragma unroll
  for (int i = 0; i < scan::kPerLane; ++i) {
    val[i] = T(0);
    ready[i] = t - scan::kWindow + lane * scan::kPerLane + i < 0;
  }
  bool done;
  unsigned int tries = 0;
  do {
    done = true;
#pragma unroll
    for (int i = 0; i < scan::kPerLane; ++i) {
      if (!ready[i]) {
        const int j = lane * scan::kPerLane + i;
        const int k = t - scan::kWindow + j;
        ready[i] = plan::try_read(j == 0 ? st.inc + k : st.agg + k, &val[i], epoch);
        done = done && ready[i];
      }
    }
    if (++tries == plan::kSpinLimit) __trap();
  } while (!__all_sync(0xffffffffu, done));
  T part = T(0);
#pragma unroll
  for (int i = 0; i < scan::kPerLane; ++i) part += val[i];
  return scan::warp_sum(part);
}

// At most 40 registers a thread, so 6 blocks fit an SM: with 48 (5 blocks)
// the kernel measured 12% slower (PERF.md §6).
constexpr int kMinBlocks = 6;

template <typename T>
__global__ void __launch_bounds__(scan::kThreads, kMinBlocks)
spmv_tiles(const int* __restrict__ src, const int* __restrict__ indptr,
           const int* __restrict__ rows, const T* __restrict__ w, const T* __restrict__ ew,
           T* __restrict__ out, long long e, unsigned int tiles, plan::CallState* cs,
           Tiles st) {
  __shared__ T tile[scan::kSmem];
  __shared__ T total;
  __shared__ T tile_excl;
  __shared__ unsigned long long ticket;
  __shared__ int s_rows[2];
  __shared__ long long s_last;
  const int tid = threadIdx.x;
  if (tid == 0) ticket = plan::take_ticket(cs);
  __syncthreads();
  // call k takes tickets [k * tiles, (k + 1) * tiles): the tile and the epoch
  const int t = static_cast<int>(ticket % tiles);
  const unsigned int epoch = plan::next_epoch(ticket / tiles);
  const long long base = static_cast<long long>(t) * scan::kTile;
  const int count = e - base < scan::kTile ? static_cast<int>(e - base) : scan::kTile;
  // thread 0: the tile's CSR pointers, and its last pointer, where a row
  // that leaves the tile starts (-1 when no row ends in the tile); their
  // loads overlap the tile's
  if (tid == 0) {
    const int i0 = rows[t], i1 = rows[t + 1];
    s_rows[0] = i0;
    s_rows[1] = i1;
    s_last = i1 - 1 >= (i0 > 1 ? i0 : 1) ? indptr[i1 - 1] : -1;
  }

  // 1. load: kItems per-edge values a thread, coalesced, the ragged end masked
  const LoadEdge<T> load{src, w, ew};
  T x[scan::kItems];
#pragma unroll
  for (int i = 0; i < scan::kItems; ++i) {
    const int k = i * scan::kThreads + tid;
    x[i] = k < count ? load.one(base + k) : T(0);
  }
#pragma unroll
  for (int i = 0; i < scan::kItems; ++i) tile[scan::padded(i * scan::kThreads + tid)] = x[i];
  __syncthreads();

  // 2. scan: each thread its kItems in order, the block over the thread
  // totals, warp 0 over the window of earlier tiles
  T v[scan::kItems];
  T run = T(0);
#pragma unroll
  for (int i = 0; i < scan::kItems; ++i) {
    run += tile[scan::padded(tid * scan::kItems + i)];
    v[i] = run;
  }
  const T pre = scan::block_exclusive_scan(run, &total);
  if (tid < 32) {
    if (tid == 0) plan::publish(st.agg + t, total, epoch);
    const T excl = lookback<T>(st, t, epoch);
    if (tid == 0) {
      plan::publish(st.inc + t, excl + total, epoch);
      tile_excl = excl;
    }
  }
  __syncthreads();
  const T excl = tile_excl;
  const T off = pre + excl;
  // c0 at the tile's last pointer, published by the thread that holds it as
  // soon as it is known: a later tile that needs it waits for this tile's
  // look-back, never for its rows
  const long long j_last = s_last;
  if (j_last == base && tid == 0) plan::publish(st.last + t, excl, epoch);
  if (j_last > base && (j_last - 1 - base) / scan::kItems == tid) {
    const int item = static_cast<int>((j_last - 1 - base) % scan::kItems);
    T c = T(0);
#pragma unroll
    for (int i = 0; i < scan::kItems; ++i) {
      if (i == item) c = off + v[i];
    }
    plan::publish(st.last + t, c, epoch);
  }
#pragma unroll
  for (int i = 0; i < scan::kItems; ++i) tile[scan::padded(tid * scan::kItems + i)] = off + v[i];
  __syncthreads();

  // 3. the rows that end in this tile; tile[padded(j - 1 - base)] is c0[j]
  // for j in (base, end], and tile 0 reads c0[0] = 0 as excl.  Pointer i0,
  // where i0 >= 1, ends the row that began in an earlier tile; the others
  // start in this one.
  const int i0 = s_rows[0], i1 = s_rows[1];
  auto c0_here = [&](long long j) {
    return j == base ? excl : tile[scan::padded(static_cast<int>(j - 1 - base))];
  };
#pragma unroll 4
  for (int i = (i0 > 0 ? i0 + 1 : 1) + tid; i < i1; i += scan::kThreads) {
    out[i - 1] = c0_here(indptr[i]) - c0_here(indptr[i - 1]);
  }
  // the row that began in an earlier tile, last: it reads c0 at its start,
  // the last pointer of tile (start - 1) / kTile, from that tile's
  // descriptor (c0[0] = 0 needs none)
  if (tid == 0 && i0 >= 1 && i0 < i1) {
    const long long j0 = indptr[i0 - 1];
    const T c1 = c0_here(indptr[i0]);
    out[i0 - 1] = c1 - (j0 == 0 ? T(0) : plan::wait_read<T>(st.last + (j0 - 1) / scan::kTile,
                                                             epoch));
  }
}

// The plan's scratch: the call state, then three descriptors a tile.
inline long long state_len(long long tiles) {
  return static_cast<long long>(sizeof(plan::CallState)) +
         3 * tiles * static_cast<long long>(sizeof(Slot));
}

template <typename T>
int spmv_launch(const int* src, const int* indptr, const int* rows, const T* w, const T* ew,
                T* out, void* state, long long state_bytes, long long e, long long n,
                cudaStream_t stream) {
  if (e < 0 || n < 0 || n >= INT_MAX || e > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  if (e == 0) return static_cast<int>(cudaMemsetAsync(out, 0, n * sizeof(T), stream));
  const long long tiles = scan::tiles_for(e);
  if (state_bytes < state_len(tiles)) return static_cast<int>(cudaErrorInvalidValue);
  auto* slots = reinterpret_cast<Slot*>(static_cast<char*>(state) + sizeof(plan::CallState));
  const Tiles st{slots, slots + tiles, slots + 2 * tiles};
  spmv_tiles<T><<<static_cast<unsigned>(tiles), scan::kThreads, 0, stream>>>(
      src, indptr, rows, w, ew, out, e, static_cast<unsigned>(tiles),
      static_cast<plan::CallState*>(state), st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of the plan's scratch for e edges: the call state and three
// descriptors a tile.
long long spmv_scratch_len(long long e) {
  if (e <= 0) return 0;
  return state_len(scan::tiles_for(e));
}

// Edges per tile.
int spmv_tile_len() { return scan::kTile; }

// rows: the plan's int32 [tiles + 1] first CSR pointer of each tile; state:
// its scratch of state_bytes, zeroed when the plan was built.
int spmv_f32(const void* src, const void* indptr, const void* rows, const void* w,
             const void* ew, void* out, void* state, long long state_bytes, long long e,
             long long n, void* stream) {
  return spmv_launch(static_cast<const int*>(src), static_cast<const int*>(indptr),
                     static_cast<const int*>(rows), static_cast<const float*>(w),
                     static_cast<const float*>(ew), static_cast<float*>(out), state,
                     state_bytes, e, n, static_cast<cudaStream_t>(stream));
}

int spmv_f64(const void* src, const void* indptr, const void* rows, const void* w,
             const void* ew, void* out, void* state, long long state_bytes, long long e,
             long long n, void* stream) {
  return spmv_launch(static_cast<const int*>(src), static_cast<const int*>(indptr),
                     static_cast<const int*>(rows), static_cast<const double*>(w),
                     static_cast<const double*>(ew), static_cast<double*>(out), state,
                     state_bytes, e, n, static_cast<cudaStream_t>(stream));
}

const char* spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
