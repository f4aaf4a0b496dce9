// Row sums of the hybrid SpMV's dense head matrix (spmv_impl='hybrid').
//
// Replaces: page_rank_and_tfidf_using_apache_spark_tpu/ops/pallas_kernels.py
//   rowsum_pallas (body _rowsum_kernel).  The TPU kernel streams 1024-row
//   blocks through VMEM and reduces each with one [RB, W] @ ones[W] matrix
//   unit product at Precision.HIGHEST.
//
// Bound on the H100: bytes.  Each element is read once and added once
// (R*(W-1) adds, far below the float32 rate), so the least time is the
// R*W*sizeof(T) bytes read (plus R*sizeof(T) written) over 3.35 TB/s.
//
// Design: no matrix unit.  A group of G lanes reduces one row, where G is
// the row width rounded up to a power of two and capped at 32 (one warp
// per row for W >= 32, 32/G rows per warp below that).  Lane j of a group
// adds elements j, j+G, j+2G, ... of its row, so a warp's loads of one
// step are contiguous; the G partial sums are combined with xor shuffles
// that stay inside the group.  The sums run in float32 or float64 on the
// CUDA cores, so no TF32 rounding arises.  Any width works; the hybrid
// layout gives a power of two in [8, head_row_width].
//
// C interface (loaded with ctypes): device pointers, a cudaStream_t, and
// the cudaError_t of the launch as the return value (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rowsum_rows(const T* __restrict__ mat, T* __restrict__ out,
            long long rows, int width, int group) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (group - 1);  // lane within its row group
  const long long rows_per_block = kThreads / group;
  const long long row = static_cast<long long>(blockIdx.x) * rows_per_block + threadIdx.x / group;
  T s = T(0);
  if (row < rows) {
    const T* p = mat + row * width;
    for (int j = sub; j < width; j += group) s += p[j];
  }
  // Every lane of the warp takes part in the shuffles, rows past the end
  // with s = 0; xor offsets below `group` never leave the group.
  for (int off = group >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && sub == 0) out[row] = s;
}

int group_for(int width) {
  int g = 1;
  while (g < width && g < 32) g <<= 1;
  return g;
}

template <typename T>
int rowsum_launch(const T* mat, T* out, long long rows, int width, cudaStream_t stream) {
  if (rows <= 0) return 0;
  const int group = group_for(width);
  const long long rows_per_block = kThreads / group;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  rowsum_rows<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(mat, out, rows, width, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rowsum_f32(const void* mat, void* out, long long rows, int width, void* stream) {
  return rowsum_launch(static_cast<const float*>(mat), static_cast<float*>(out), rows, width,
                       static_cast<cudaStream_t>(stream));
}

int rowsum_f64(const void* mat, void* out, long long rows, int width, void* stream) {
  return rowsum_launch(static_cast<const double*>(mat), static_cast<double*>(out), rows, width,
                       static_cast<cudaStream_t>(stream));
}

const char* rowsum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
