// Inclusive 1-D prefix sum for the PageRank SpMV (spmv_impl='pallas').
//
// Replaces: page_rank_and_tfidf_using_apache_spark_tpu/ops/pallas_kernels.py
//   cumsum_pallas (body _cumsum_carry_kernel and _scan_axis).  The TPU kernel
//   walks 256K-element chunks on a sequential grid and threads the running
//   total through a scalar in SMEM.  Blocks on Hopper run in no order, so
//   that carry has no counterpart here.
//
// Bound on the H100: bytes.  The work is one add per element; the least
// traffic is one read and one write of the array, 2*E*sizeof(T) bytes
// (about 41 MB, 12 us at 3.35 TB/s, for E = 5.1M in float32).
//
// Design: a three-pass reduce-then-scan over tiles of kTile elements.
//   1. tile_sums: each block sums its tile (coalesced loads, warp shuffles).
//   2. scan_tile_sums: one block turns the tile sums into exclusive tile
//      offsets, looping over them kTile at a time with a running carry.
//   3. scan_tiles: each block stages its tile in shared memory, each thread
//      scans kItems contiguous elements serially, the per-thread totals are
//      scanned with warp shuffles, and the tile offset is added.
// Passes 1 and 3 each read the input once, so the kernel moves about
// 3*E*sizeof(T) bytes against the 2*E*sizeof(T) bound; a single-pass
// decoupled-lookback scan, or fusing the gather and the CSR difference
// around it, is later work.  The ragged tail is masked; nothing is padded.
//
// C interface (loaded with ctypes): every pointer is a device pointer, the
// stream is a cudaStream_t, and each launch function returns the
// cudaError_t of its launches (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 2048 elements per block
constexpr int kWarps = kThreads / 32;

// Shared-memory index with one pad word every 32, so that thread t reading
// element t*kItems+i hits 32 different banks.
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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Exclusive scan of one value per thread across the block.  Stores the
// block total in *total (shared) and returns this thread's exclusive prefix.
// Ends with a barrier, so it may be called again in a loop.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_sums(const T* __restrict__ x, T* __restrict__ sums, long long n) {
  __shared__ T warp_tot[kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  T s = T(0);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long j = base + i * kThreads + threadIdx.x;
    if (j < n) s += x[j];
  }
  s = warp_sum(s);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_tot[warp] = s;
  __syncthreads();
  if (warp == 0) {
    T t = lane < kWarps ? warp_tot[lane] : T(0);
    t = warp_sum(t);
    if (lane == 0) sums[blockIdx.x] = t;
  }
}

// In place: sums[k] becomes the sum of sums[0..k), for k < m.  One block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_tile_sums(T* __restrict__ sums, long long m) {
  __shared__ T round_total;
  T carry = T(0);
  for (long long base = 0; base < m; base += kTile) {
    const long long start = base + static_cast<long long>(threadIdx.x) * kItems;
    T v[kItems];
    T local = T(0);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      v[i] = start + i < m ? sums[start + i] : T(0);
      local += v[i];
    }
    T pre = block_exclusive_scan(local, &round_total) + carry;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (start + i < m) sums[start + i] = pre;
      pre += v[i];
    }
    carry += round_total;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_tiles(const T* __restrict__ x, T* __restrict__ out,
           const T* __restrict__ offsets, long long n) {
  __shared__ T tile[kTile + kTile / 32];
  __shared__ T block_total;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = i * kThreads + threadIdx.x;
    tile[padded(k)] = base + k < n ? x[base + k] : T(0);
  }
  __syncthreads();
  T v[kItems];
  T run = T(0);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    run += tile[padded(threadIdx.x * kItems + i)];
    v[i] = run;
  }
  const T pre = block_exclusive_scan(run, &block_total) + offsets[blockIdx.x];
#pragma unroll
  for (int i = 0; i < kItems; ++i) tile[padded(threadIdx.x * kItems + i)] = pre + v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = i * kThreads + threadIdx.x;
    if (base + k < n) out[base + k] = tile[padded(k)];
  }
}

template <typename T>
int cumsum_launch(const T* x, T* out, T* scratch, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long tiles = (n + kTile - 1) / kTile;
  tile_sums<T><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(x, scratch, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_tile_sums<T><<<1, kThreads, 0, stream>>>(scratch, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_tiles<T><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(x, out, scratch, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Elements of scratch (of the input's type) that a call on n elements needs.
long long cumsum_scratch_len(long long n) { return n <= 0 ? 0 : (n + kTile - 1) / kTile; }

int cumsum_f32(const void* x, void* out, void* scratch, long long n, void* stream) {
  return cumsum_launch(static_cast<const float*>(x), static_cast<float*>(out),
                       static_cast<float*>(scratch), n, static_cast<cudaStream_t>(stream));
}

int cumsum_f64(const void* x, void* out, void* scratch, long long n, void* stream) {
  return cumsum_launch(static_cast<const double*>(x), static_cast<double*>(out),
                       static_cast<double*>(scratch), n, static_cast<cudaStream_t>(stream));
}

const char* cumsum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
