// Same-shape gather within blocks of 8 rows: the SpMV cost probe's
// lane / sublane / broadcast-row take_along_axis (tools/gather_micro.py).
//
// Replaces: tools/gather_micro.py:77 (make_runner.kernel, pallas_call at
//   :87-98).  Every grid step of the TPU kernel sees the same (8, W) block
//   of x in VMEM (index map (0, 0)) and gathers from it with the next 8 rows
//   of idx:
//     lane      (axis 1)  out[8i+r, j] = x[r, idx[8i+r, j]]
//     broadcast (x 1 row) out[8i+r, j] = x[0, idx[8i+r, j]]
//     sublane   (axis 0)  out[8i+r, j] = x[idx[8i+r, j], j]
//   The TPU probe asked how wide a VMEM-local gather may be before Mosaic
//   fails to lower it.  On Hopper the question is ns per gather against the
//   table's width, and the answer depends on where the table is read from.
//
// Bound on the H100: bytes.  Each gather reads 4 bytes of idx and writes 4
// bytes of out; the table is read once (at most 8 x W floats).  At lane
// W = 109184 (4,367,360 gathers) that is 34.9 MB plus 3.5 MB, about 11.5 us
// at 3.35 TB/s; at W = 128 (4,399,104 gathers) 35.2 MB, about 10.5 us.  The
// streams of idx and out set the pace, so the table's reads must not.
//
// Design: like the TPU kernel, a gather reads its table from fast memory.
// Two routes, chosen by the caller (ops/gather_kernels.py):
//   - staged: a block copies what its outputs read of the table into shared
//     memory with one TMA bulk copy (cp.async.bulk completing on an
//     mbarrier), issues its first 16-byte idx loads while the copy is in
//     flight, then streams its share of idx and out (16-byte loads and
//     stores, 4 quads a thread in flight) and gathers from shared memory.
//     Sublane stages the whole table (8 rows: W <= 7,260 in the H100's
//     232,432 bytes a block).  Lane splits the output rows into the 8
//     residues g % 8 (one group for the broadcast row) and a block serves
//     one, so it stages one row, 1/8 of the table (W <= 58,108).  The grid
//     is one wave (occupancy by shared memory), at most what the group's
//     idx fills, so each block copies its row from L2 once.
//   - L2 loop: a grid-stride loop, 4 outputs a thread, table reads through
//     the read-only path (__ldg).  It takes what staging cannot (a width not
//     a multiple of 4, a pointer not 16-byte aligned, a table part wider
//     than a block) and what it does not speed up: a table of 128 KB or less
//     stays in L1 on this loop (lane W <= 4,096), where staging measured
//     up to 7% slower.
// Measured on the H100 (PERF.md section 6): staging held 0.0203-0.0214 ms
// from lane W = 128 to 32,768, where the L2 loop rose from 0.0190 to
// 0.0367 ms as the table outgrew L1.  Past one row a block (lane W =
// 109,184, the web-Google rank vector's size) a thread-block cluster of 2
// split the row and read the other half through distributed shared memory,
// and lost to the L2 loop (0.0441 against 0.0429 ms): random 4-byte remote
// reads cost more than the L2 sectors they save.  So that width stays on
// the L2 loop.  Offsets are 64-bit.
// Indices are not checked: they must lie in [0, W) for axis 1 and [0, 8)
// for axis 0.  A route that does not fit is refused, never replaced.
//
// C interface (loaded with ctypes): device pointers, a cudaStream_t, and
// the cudaError_t of the launch as the return value (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockRows = 8;           // rows of the x block each output row gathers from
constexpr int kThreads = 256;           // L2 loop
constexpr long long kMaxBlocks = 8192;  // L2 loop: grid-stride beyond this
constexpr int kStagedThreads = 512;     // staged route
constexpr int kUnroll = 4;              // staged route: quads a thread loads before it gathers
constexpr int kBarrierBytes = 16;       // the mbarrier, ahead of the staged table

// ---- L2 loop ----

// Table row and column of output element (g, j) whose index is k.
template <int kAxis>
__device__ __forceinline__ long long table_offset(long long g, int j, int k, bool bcast,
                                                  int width) {
  if (kAxis == 1) {
    const long long r = bcast ? 0 : (g & (kBlockRows - 1));
    return r * width + k;
  }
  const long long r = bcast ? 0 : k;
  return r * width + j;
}

template <int kAxis>
__global__ void __launch_bounds__(kThreads)
gather_rows(const float* __restrict__ x, const int* __restrict__ idx, float* __restrict__ out,
            bool bcast, long long rows, int width, bool vec) {
  const long long quads = (width + 3) / 4;  // 4-element groups per row
  const long long total = rows * quads;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; q < total;
       q += stride) {
    const long long g = q / quads;
    const int j0 = static_cast<int>(q - g * quads) * 4;
    const long long base = g * width + j0;
    if (vec) {  // width % 4 == 0 and 16-byte aligned idx and out
      const int4 k = *reinterpret_cast<const int4*>(idx + base);
      float4 v;
      v.x = __ldg(x + table_offset<kAxis>(g, j0 + 0, k.x, bcast, width));
      v.y = __ldg(x + table_offset<kAxis>(g, j0 + 1, k.y, bcast, width));
      v.z = __ldg(x + table_offset<kAxis>(g, j0 + 2, k.z, bcast, width));
      v.w = __ldg(x + table_offset<kAxis>(g, j0 + 3, k.w, bcast, width));
      *reinterpret_cast<float4*>(out + base) = v;
    } else {
      for (int t = 0; t < 4 && j0 + t < width; ++t) {
        out[base + t] = __ldg(x + table_offset<kAxis>(g, j0 + t, idx[base + t], bcast, width));
      }
    }
  }
}

// ---- staged route ----

__device__ __forceinline__ std::uint32_t smem_addr(const void* p) {
  return static_cast<std::uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0: arm `bar` for `bytes` and copy them from global `src` to shared
// `dst` with one bulk copy that completes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, std::uint32_t bytes,
                                          std::uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Wait for phase `parity` of `bar` to complete.  A copy that never lands
// traps after 2^26 tries (far beyond any copy's time), so a fault surfaces
// as a launch error rather than a hung card.
__device__ __forceinline__ void barrier_wait(std::uint64_t* bar, std::uint32_t parity) {
  for (std::uint32_t tries = 0;; ++tries) {
    std::uint32_t done = 0;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n" : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// One launch of the staged route.  The output rows fall into `groups`
// groups (group r holds rows g = groups*i + r); `per_group` consecutive
// blocks serve a group.  Each block stages `stage_len` floats of x from
// element r*W (lane: row r; sublane: all of x, with groups 1), then takes
// its share of the group's quads.  Sublane reads table row k at
// k * row_stride (0 for the broadcast row).
template <int kAxis>
__global__ void __launch_bounds__(kStagedThreads)
gather_staged(const float* __restrict__ x, const int* __restrict__ idx, float* __restrict__ out,
              long long group_rows, int width, int groups, int per_group, int stage_len,
              int row_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* bar = reinterpret_cast<std::uint64_t*>(smem);
  float* table = reinterpret_cast<float*>(smem + kBarrierBytes);
  const int r = blockIdx.x / per_group;
  const int kb = blockIdx.x - r * per_group;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bulk_copy(table, x + static_cast<long long>(r) * width,
              static_cast<std::uint32_t>(stage_len) * 4u, bar);
  }

  // This block's quads [q0, q1) of the group's group_rows x wq, walked with
  // a stride of one block; (i, jq) follows q without a division per step.
  const long long wq = width / 4;
  const long long n = group_rows * wq;
  const long long q1 = n * (kb + 1) / per_group;
  const long long step = blockDim.x;
  const long long si = step / wq, sj = step - si * wq;
  long long q = n * kb / per_group + threadIdx.x;
  long long i = q / wq, jq = q - i * wq;
  int4 k[kUnroll];
  long long off[kUnroll];
  int col[kUnroll];
  bool ok[kUnroll];
  auto load = [&]() {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ok[u] = q < q1;
      if (ok[u]) {
        col[u] = static_cast<int>(jq) * 4;
        off[u] = (groups * i + r) * width + col[u];
        k[u] = __ldcs(reinterpret_cast<const int4*>(idx + off[u]));
      }
      q += step;
      i += si;
      jq += sj;
      if (jq >= wq) {
        jq -= wq;
        ++i;
      }
    }
  };
  auto fetch = [&](int kk, int j) -> float {
    return kAxis == 0 ? table[kk * row_stride + j] : table[kk];
  };

  load();  // the first idx loads overlap the bulk copy
  barrier_wait(bar, 0);
  while (ok[0]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (ok[u]) {
        float4 v;
        v.x = fetch(k[u].x, col[u] + 0);
        v.y = fetch(k[u].y, col[u] + 1);
        v.z = fetch(k[u].z, col[u] + 2);
        v.w = fetch(k[u].w, col[u] + 3);
        __stcs(reinterpret_cast<float4*>(out + off[u]), v);
      }
    }
    load();
  }
}

int device_attribute(cudaDeviceAttr attr, int* value) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(value, attr, dev);
  return static_cast<int>(err);
}

template <int kAxis>
int launch_staged(const float* x, const int* idx, float* out, int x_rows, long long rows,
                  int width, cudaStream_t stream) {
  int limit = 0;
  int rc = device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin, &limit);
  if (rc != 0) return rc;
  const int groups = kAxis == 1 && x_rows == kBlockRows ? kBlockRows : 1;
  const int stage_len = kAxis == 0 ? x_rows * width : width;
  if (width % 4 || static_cast<long long>(stage_len) * 4 > limit - kBarrierBytes ||
      (reinterpret_cast<std::uintptr_t>(x) | reinterpret_cast<std::uintptr_t>(idx) |
       reinterpret_cast<std::uintptr_t>(out)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = kBarrierBytes + stage_len * 4;
  auto kernel = gather_staged<kAxis>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kStagedThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  rc = device_attribute(cudaDevAttrMultiProcessorCount, &sms);
  if (rc != 0) return rc;
  // blocks per group: a wave's share, no more than the group's quads fill
  const long long group_rows = rows / groups;
  const long long quads = group_rows * (width / 4);
  long long per_group = static_cast<long long>(per_sm) * sms / groups;
  const long long fill = (quads + kStagedThreads * kUnroll - 1) / (kStagedThreads * kUnroll);
  if (per_group > fill) per_group = fill;
  if (per_group < 1) per_group = 1;
  kernel<<<static_cast<unsigned>(groups * per_group), kStagedThreads, smem, stream>>>(
      x, idx, out, group_rows, width, groups, static_cast<int>(per_group), stage_len,
      x_rows == 1 ? 0 : width);
  return static_cast<int>(cudaGetLastError());
}

template <int kAxis>
int launch(const float* x, const int* idx, float* out, int x_rows, long long rows, int width,
           bool staged, cudaStream_t stream) {
  if (staged) return launch_staged<kAxis>(x, idx, out, x_rows, rows, width, stream);
  const bool vec = width % 4 == 0 &&
                   (reinterpret_cast<std::uintptr_t>(idx) |
                    reinterpret_cast<std::uintptr_t>(out)) % 16 == 0;
  const long long total = rows * ((width + 3) / 4);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_rows<kAxis><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, idx, out, x_rows == 1, rows, width, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: float32 [x_rows, width] with x_rows 8, or 1 for the broadcast row;
// idx: int32 [rows, width]; out: float32 [rows, width]; rows a multiple of 8.
// staged: 1 for the staged route, 0 for the L2 loop.
int gather_f32(const void* x, const void* idx, void* out, int x_rows, long long rows, int width,
               int axis, int staged, void* stream) {
  if ((x_rows != 1 && x_rows != kBlockRows) || (axis != 0 && axis != 1) || rows < 0 ||
      width < 0 || rows % kBlockRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || width == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* ip = static_cast<const int*>(idx);
  auto* op = static_cast<float*>(out);
  return axis == 1 ? launch<1>(xp, ip, op, x_rows, rows, width, staged != 0, s)
                   : launch<0>(xp, ip, op, x_rows, rows, width, staged != 0, s);
}

// Bytes of table a block of the staged route can hold on the current
// device (its opt-in shared memory less the barrier), or -1.
int gather_table_limit() {
  int limit = 0;
  if (device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin, &limit) != 0) return -1;
  return limit - kBarrierBytes;
}

const char* gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
