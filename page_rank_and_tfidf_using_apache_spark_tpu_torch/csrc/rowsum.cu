// Row sums of the hybrid SpMV's dense head matrix (spmv_impl='hybrid').
//
// Replaces: page_rank_and_tfidf_using_apache_spark_tpu/ops/pallas_kernels.py
//   rowsum_pallas (body _rowsum_kernel).  The TPU kernel streams 1024-row
//   blocks through VMEM in one HBM pass and reduces each with one
//   [RB, W] @ ones[W] matrix unit product at Precision.HIGHEST.
//
// Bound on the H100: bytes.  Each element is read once and added once
// (R*(W-1) adds, far below the float32 rate), so the least time is the
// R*W*sizeof(T) bytes read (plus R*sizeof(T) written) over 3.35 TB/s: at
// the main path's [15,112, 128] float32, 7.8 MB, 2.3 us.
//
// Design: no matrix unit; the sums run in float32 or float64 on the CUDA
// cores, so no TF32 rounding arises.  Where W is a multiple of 4 on a
// 16-byte aligned base, a group of G lanes (G the row's 16-byte vectors
// rounded up to a power of two, capped at 32) shares a row, and each lane
// issues 2 loads of 16 bytes along it before it adds them (at W = 128
// float32 one float4 a lane: a warp reads a row in one request).  The grid
// is one wave (resident blocks x SMs), or fewer blocks where the rows run
// out first; each block walks a contiguous run of rows, its warps side by
// side, with its bounds computed on the host.  A lane adds its row's
// vectors in column order, then the G partial sums meet in xor shuffles
// inside the group, so the order is fixed by W alone: no atomics, the same
// bits from any grid.  Other widths (not a multiple of 4, or below 4) and
// unaligned bases (a row slice of an odd-width matrix) take the scalar
// lane-group loop: lane j of a group adds elements j, j+G, j+2G, ... of its
// row, one row group per warp.
//
// What holds it back (H100 measurements, PERF.md section 6): at the main
// path's 7.8 MB, the timing protocol's own floor of about 5 us and the
// memory latency, not the bytes in flight.  A warp already reads a whole
// row per request, and a one-row-per-warp grid has megabytes in flight.
// Eight rows in flight per lane (128 bytes, not 16) made it slower, as did
// eight loads a lane along the row (more registers, a smaller wave).  This
// design ties the scalar loop at the main path and is faster on narrow
// (W = 16) and wide (W = 512, 1000) rows.
//
// C interface (loaded with ctypes): device pointers, a cudaStream_t, and
// the cudaError_t of the launch as the return value (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kInFlight = 2;  // 16-byte loads a lane issues along its row before it adds

// ---- scalar lane-group loop ----

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

// ---- 16-byte route ----

template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  static __device__ __forceinline__ float add(float s, float4 v) {
    s += v.x;
    s += v.y;
    s += v.z;
    return s + v.w;
  }
};
template <> struct Vec16<double> {
  using type = double2;
  static __device__ __forceinline__ double add(double s, double2 v) {
    s += v.x;
    return s + v.y;
  }
};

// A task is one row for each of the warp's 32/group lane groups; nvec
// 16-byte vectors a row.  Block b takes tasks [b*per_block, ...), its warps
// side by side.  Lane `sub` of a group loads columns sub, sub+group, ... of
// its row, kInFlight vectors at a time, before it adds them.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rowsum_vec(const T* __restrict__ mat, T* __restrict__ out, long long rows, int nvec, int group,
           long long tasks, long long per_block) {
  using V = typename Vec16<T>::type;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (group - 1);
  const long long slots = 32 / group;
  const V* m = reinterpret_cast<const V*>(mat);
  const long long t0 = per_block * blockIdx.x;
  const long long t1 = t0 + per_block < tasks ? t0 + per_block : tasks;
  for (long long t = t0 + threadIdx.x / 32; t < t1; t += kWarps) {
    const long long row = t * slots + lane / group;
    T s = T(0);
    for (int c0 = sub; c0 < nvec; c0 += kInFlight * group) {
      V v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int c = c0 + u * group;
        v[u] = row < rows && c < nvec ? __ldg(m + row * nvec + c) : V{};
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) s = Vec16<T>::add(s, v[u]);
    }
    for (int off = group >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (sub == 0 && row < rows) out[row] = s;
  }
}

int pow2_at_least(int n, int cap) {
  int g = 1;
  while (g < n && g < cap) g <<= 1;
  return g;
}

// The 16-byte route takes a width that is a multiple of 4 (on an aligned base).
bool vec_width(int width) { return width >= 4 && width % 4 == 0; }

// How the 16-byte route cuts a row of `width` elements of T.
struct VecPlan {
  int nvec;   // 16-byte vectors a row
  int group;  // lanes a row
};

template <typename T>
VecPlan vec_plan(int width) {
  const int nvec = width / (16 / static_cast<int>(sizeof(T)));
  return {nvec, pow2_at_least(nvec, 32)};
}

// Blocks of `kernel` resident at once on the current device.
template <typename K>
cudaError_t wave_of(K kernel, long long* wave) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *wave = static_cast<long long>(per_sm) * sms;
  return err;
}

template <typename T>
int rowsum_launch(const T* mat, T* out, long long rows, int width, cudaStream_t stream) {
  if (rows < 0 || width < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  if (vec_width(width) && reinterpret_cast<std::uintptr_t>(mat) % 16 == 0) {
    const VecPlan p = vec_plan<T>(width);
    long long wave = 0;
    const cudaError_t err = wave_of(rowsum_vec<T>, &wave);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long slots = 32 / p.group;
    const long long tasks = (rows + slots - 1) / slots;
    long long blocks = (tasks + kWarps - 1) / kWarps;
    if (blocks > wave) blocks = wave;
    rowsum_vec<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        mat, out, rows, p.nvec, p.group, tasks, (tasks + blocks - 1) / blocks);
    return static_cast<int>(cudaGetLastError());
  }
  const int group = pow2_at_least(width, 32);
  const long long rows_per_block = kThreads / group;
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  rowsum_rows<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(mat, out, rows, width,
                                                                          group);
  return static_cast<int>(cudaGetLastError());
}

// Rows one block covers when each warp takes one task, and the blocks of
// one wave, for an aligned [*, width] matrix of T.
template <typename T>
int plan(int width, long long* block_rows, long long* wave_blocks) {
  if (width < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (vec_width(width)) {
    *block_rows = static_cast<long long>(kWarps) * (32 / vec_plan<T>(width).group);
    return static_cast<int>(wave_of(rowsum_vec<T>, wave_blocks));
  }
  *block_rows = kThreads / pow2_at_least(width, 32);
  return static_cast<int>(wave_of(rowsum_rows<T>, wave_blocks));
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

// The launch plan for an aligned [*, width] matrix of elem_size-byte
// floats (4 or 8): rows one block covers with one task a warp (one row
// group a warp on the scalar loop), and the blocks of one wave.  Returns
// the cudaError_t of the occupancy query.
int rowsum_plan(int width, int elem_size, long long* block_rows, long long* wave_blocks) {
  if (elem_size == 4) return plan<float>(width, block_rows, wave_blocks);
  if (elem_size == 8) return plan<double>(width, block_rows, wave_blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rowsum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
