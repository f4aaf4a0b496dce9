// Inclusive 1-D prefix sum: the counterpart of cumsum_pallas.
//
// Replaces: page_rank_and_tfidf_using_apache_spark_tpu/ops/pallas_kernels.py
//   cumsum_pallas (body _cumsum_carry_kernel and _scan_axis).  The TPU kernel
//   walks 256K-element chunks on a sequential grid and threads the running
//   total through a scalar in SMEM, so it reads the input once.  Blocks on
//   Hopper run in no order, so that carry becomes a chained scan across
//   tiles (scan.cuh).  On the PageRank main path (spmv_impl='pallas') the
//   same scan runs inside spmv.cu's fused kernel; this file keeps the scan
//   on its own.
//
// Bound on the H100: bytes.  The work is one add per element; the least
// traffic is one read and one write of the array, 2*E*sizeof(T) bytes:
// 28.5 MB, 8.5 us at 3.35 TB/s, for the main path's E = 3,563,796 in float32.
//
// Design: a single-pass chained scan with a deterministic fixed-window
// decoupled look-back (scan.cuh).  The input is read once and the output
// written once, with 16-byte loads and stores on full tiles (one element a
// thread at a time measured slower on the H100: PERF.md §6).  A call is one
// cudaMemsetAsync of the tile descriptors and the ticket counter, then one
// kernel of ceil(E / 4096) blocks of 256 threads.  Tiles are 4096 elements
// (871 at the main path's E); the ragged tail is masked, nothing is padded.
// Two calls on one input give the same bits.
//
// C interface (loaded with ctypes): every pointer is a device pointer, the
// stream is a cudaStream_t, and each launch function returns the
// cudaError_t of its launches (0 on success).

#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

template <typename T>
struct LoadInput {
  static constexpr bool kVec = true;
  const T* x;
  bool vec_ok;
  __device__ T one(long long e) const { return x[e]; }
  __device__ typename scan::Vec<T>::type vec(long long e) const {
    return *reinterpret_cast<const typename scan::Vec<T>::type*>(x + e);
  }
};

template <typename T>
__global__ void __launch_bounds__(scan::kThreads)
cumsum_tiles(const T* __restrict__ x, T* __restrict__ out, long long n, scan::TileState st) {
  __shared__ T tile[scan::kSmem];
  const int t = scan::take_ticket(st);
  const long long base = static_cast<long long>(t) * scan::kTile;
  const int count = n - base < scan::kTile ? static_cast<int>(n - base) : scan::kTile;
  scan::scan_tile(tile, st, t, base, count, LoadInput<T>{x, scan::aligned(x, 16)},
                  scan::NoSide{});
  constexpr int V = scan::Vec<T>::kN;
  if (count == scan::kTile && scan::aligned(out, 16)) {
#pragma unroll
    for (int i = 0; i < scan::kItems / V; ++i) {
      const int k = (i * scan::kThreads + threadIdx.x) * V;
      T v[V];
#pragma unroll
      for (int c = 0; c < V; ++c) v[c] = tile[scan::padded(k + c)];
      *reinterpret_cast<typename scan::Vec<T>::type*>(out + base + k) = scan::pack(v);
    }
  } else {
#pragma unroll
    for (int i = 0; i < scan::kItems; ++i) {
      const int k = i * scan::kThreads + threadIdx.x;
      if (k < count) out[base + k] = tile[scan::padded(k)];
    }
  }
}

template <typename T>
int cumsum_launch(const T* x, T* out, void* scratch, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long tiles = scan::tiles_for(n);
  cudaError_t err = cudaMemsetAsync(scratch, 0, scan::state_bytes(tiles), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  cumsum_tiles<T><<<static_cast<unsigned>(tiles), scan::kThreads, 0, stream>>>(
      x, out, n, scan::state_at(scratch, tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of scratch a call on n elements needs: the ticket counter and the
// tile descriptors.
long long cumsum_scratch_len(long long n) {
  return n <= 0 ? 0 : scan::state_bytes(scan::tiles_for(n));
}

int cumsum_f32(const void* x, void* out, void* scratch, long long n, void* stream) {
  return cumsum_launch(static_cast<const float*>(x), static_cast<float*>(out), scratch, n,
                       static_cast<cudaStream_t>(stream));
}

int cumsum_f64(const void* x, void* out, void* scratch, long long n, void* stream) {
  return cumsum_launch(static_cast<const double*>(x), static_cast<double*>(out), scratch, n,
                       static_cast<cudaStream_t>(stream));
}

const char* cumsum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
