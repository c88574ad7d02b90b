// cms_update: a count-min table's update in one launch. For every key j
// of n and every row r of d, with b = (int32) idx_rows[r, j] (an int64
// bucket cut to its low 32 bits, as `.to(torch.int32)` cuts it) and the
// flat cell f = b + r * w computed in int32 with wrap-around:
//   counts[f] += weights[j] (1 where there are no weights)
// when b >= 0 and 0 <= f < d * w; every other (row, key) is dropped. A
// bucket >= w lands in the next row's cells, as the flat index of the
// TPU function does.
//
// Replaces the TPU function zipkin_tpu/ops/pallas_kernels.py:cms_update,
// which builds the [d x n] flat index and the broadcast weights in XLA
// and runs one flat_histogram (_hist_kernel) over the d x w cells. Here
// the kernel reads the [d, n] buckets where they are and computes each
// row's cell itself, so the call builds no flat-index tensor and no
// weight broadcast: the wrapper makes one check chain, then this launch.
// It serves the standalone sketch API (ops/cms.update); the ingest step
// fuses its own count-min site into flat_histogram.
//
// What bounds it on an H100: memory. A call must read each bucket once
// (4 or 8 bytes), each weight once (4 bytes, where given), and
// read-modify-write each touched cell once:
//   bound = (d x n x bucket bytes + n x 4 B if weighted
//            + touched cells x 8 B) / 3.35 TB/s,
// about 0.7 us for 4 x 114,688 int32 buckets into 4 x 2^16 cells. At
// that size the launch itself, not the bytes, sets the floor.
//
// Design:
// - One thread a key: it reads the key's weight once for all d rows and
//   the key's buckets kRows rows at a time (kRows loads in flight, each a
//   coalesced line a warp, since a row's keys are contiguous), streamed
//   past L2 (__ldcs) so the table (1 MB at 4 x 2^16) stays there for the
//   atomics. Blocks stride over the keys, at most kBlocksPerSm a
//   multiprocessor.
// - Hot cells: count-min keys are skewed by nature (a few traces and
//   services carry most spans), so the lanes of a warp whose (row, key)
//   land on one cell are grouped with __match_any_sync; the group's
//   lowest lane adds the group's summed weight with one atomic.
// - No private copy in shared memory (flat_histogram.cu's small-array
//   path): one 2^16-cell int32 row is 256 KB, over the 227 KB a block can
//   hold, and a table is d such rows. The atomics land in L2.
// Every add is an int32 add, so the result is bitwise independent of the
// order in which atomics land.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ int32_t low32(int32_t v) { return v; }
__device__ __forceinline__ int32_t low32(long long v) {
  return (int32_t)(uint32_t)(unsigned long long)v;
}

// Adds one (cell, w) a lane to counts; `ok` false drops it. Every lane of
// the warp calls it together.
__device__ __forceinline__ void add_cell(int32_t* counts, int32_t cell,
                                         int32_t w, bool ok, bool weighted) {
  unsigned peers = __match_any_sync(0xffffffffu, ok ? cell : -1);
  if (!ok) return;
  int32_t sum = __popc(peers);
  if (weighted) {
    sum = 0;
    for (unsigned p = peers; p; p &= p - 1)
      sum += __shfl_sync(peers, w, __ffs(p) - 1);
  }
  if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(counts + cell, sum);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cms_update_rows(int32_t* __restrict__ counts,
                    const T* __restrict__ idx_rows,
                    const int32_t* __restrict__ weights, int d, int w,
                    long long n) {
  const bool weighted = weights != nullptr;
  const int32_t cells = d * w;  // the wrapper keeps d x w < 2^31
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kThreads;
  // base is the same for the warp's lanes, so they take the same trips
  // and __match_any_sync always sees the full warp.
  for (long long base = (long long)blockIdx.x * kThreads + (threadIdx.x - lane);
       base < n; base += stride) {
    const long long j = base + lane;
    const bool live = j < n;
    const int32_t wt = (weighted && live) ? __ldcs(weights + j) : 1;
    for (int r0 = 0; r0 < d; r0 += kRows) {
      int32_t b[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        b[u] = (live && r0 + u < d)
                   ? low32(__ldcs(idx_rows + (long long)(r0 + u) * n + j))
                   : -1;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int32_t cell =
            (int32_t)((uint32_t)b[u] + (uint32_t)(r0 + u) * (uint32_t)w);
        add_cell(counts, cell, wt, b[u] >= 0 && cell >= 0 && cell < cells,
                 weighted);
      }
    }
  }
}

}  // namespace

// counts: int32 [d, w] on the device, updated in place; idx_rows: [d, n]
// buckets of idx_bytes each (4 = int32, 8 = int64), contiguous; weights:
// int32 [n], or 0 for weight 1. One launch on `stream`, none when d or n
// is 0. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int zt_cms_update(void* counts, const void* idx_rows,
                             int idx_bytes, const void* weights, int d, int w,
                             long long n, void* stream) {
  if (d < 0 || w < 0 || n < 0 || (long long)d * w > INT32_MAX ||
      (idx_bytes != 4 && idx_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if (d == 0 || n == 0) return (int)cudaGetLastError();
  // The multiprocessor count, asked once a device (the first call's).
  static int sms_of[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int& sms = sms_of[dev & 63];
  if (sms <= 0)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long most = (long long)(sms > 0 ? sms : 132) * kBlocksPerSm;
  if (blocks > most) blocks = most;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* c = (int32_t*)counts;
  const int32_t* wts = (const int32_t*)weights;
  if (idx_bytes == 4)
    cms_update_rows<int32_t><<<(unsigned)blocks, kThreads, 0, st>>>(
        c, (const int32_t*)idx_rows, wts, d, w, n);
  else
    cms_update_rows<long long><<<(unsigned)blocks, kThreads, 0, st>>>(
        c, (const long long*)idx_rows, wts, d, w, n);
  return (int)cudaGetLastError();
}
