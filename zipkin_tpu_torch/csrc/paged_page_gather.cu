// paged_page_gather: out[c, i*R + j] = (int64) col_c[pages[i]*R + j], zero
// where pages[i] is a hole (< 0 or past the last page).
//
// Replaces the TPU kernel zipkin_tpu/ops/pallas_kernels.py:paged_page_gather
// (_paged_gather_kernel), the page gather behind the paged layout's
// whole-trace reads (zipkin_tpu/store/device.py:_paged_gather_impl). On the
// TPU the caller first stacks the 14 span columns as int64 and splits them
// into a [2 x 14, capacity] int32 plane matrix, because Mosaic wants
// lane-aligned int32 blocks; the kernel then forwards one (28, R) block a
// grid step. At capacity 2^22 that plane matrix is 470 MB written on every
// trace read. This kernel computes the same function (its output equals the
// TPU output with the lo/hi planes recombined to int64) straight from the
// columns: it gets a table of the column pointers and their element sizes
// (eleven int64 columns, three int32) and builds no plane matrix.
//
// What bounds it on an H100: memory. A page moves R x (11 x 8 + 3 x 4) bytes
// in and R x 14 x 8 bytes out; there is no arithmetic. At the store's read
// shapes (K <= a few hundred pages of 128 rows) that is a few MB, so the
// launch itself is most of the time.
//
// Design: one block per (requested page, group of two columns). The block's
// threads copy the page's R contiguous elements of each column with
// coalesced loads (neighbouring threads on neighbouring rows), sign-extend
// int32 columns, and write R contiguous int64 values of the output row.
// Hole pages write zeros. No shared memory, no atomics; blocks are
// independent, so the result does not depend on their order. The wrapper
// validates a column set once and keeps its pointer table
// (zipkin_tpu_torch/ops/kernels.py:_gather_table), so a repeat call is one
// check of ``pages``, one allocation and this launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 16;
constexpr int kColsPerBlock = 2;
constexpr int kMaxThreads = 256;

struct ColTable {
  const void* ptr[kMaxCols];
  int esize[kMaxCols];
};

__global__ void page_gather(ColTable t, int n_cols,
                            const int32_t* __restrict__ pages,
                            int64_t* __restrict__ out, int k, int R,
                            long long n_pages) {
  const int i = blockIdx.x;
  const int32_t p = pages[i];
  const bool hole = p < 0 || (long long)p >= n_pages;
  const long long src0 = hole ? 0 : (long long)p * R;
  const long long out_cols = (long long)k * R;
  for (int cc = 0; cc < kColsPerBlock; ++cc) {
    const int c = blockIdx.y * kColsPerBlock + cc;
    if (c >= n_cols) break;
    int64_t* dst = out + c * out_cols + (long long)i * R;
    if (hole) {
      for (int j = threadIdx.x; j < R; j += blockDim.x) dst[j] = 0;
    } else if (t.esize[c] == 8) {
      const int64_t* src = static_cast<const int64_t*>(t.ptr[c]) + src0;
      for (int j = threadIdx.x; j < R; j += blockDim.x) dst[j] = src[j];
    } else {
      const int32_t* src = static_cast<const int32_t*>(t.ptr[c]) + src0;
      for (int j = threadIdx.x; j < R; j += blockDim.x)
        dst[j] = (int64_t)src[j];
    }
  }
}

}  // namespace

// cols: n_cols device pointers (host array), each a column of n_pages * R
// elements of elem_sizes[c] bytes (8 = int64, 4 = int32); pages: int32 [k]
// on the device; out: int64 [n_cols, k * R] on the device.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int zt_paged_page_gather(const void* const* cols,
                                    const int* elem_sizes, int n_cols,
                                    const void* pages, void* out, int k,
                                    int R, long long n_pages, void* stream) {
  if (n_cols <= 0 || n_cols > kMaxCols || R <= 0 || n_pages <= 0)
    return (int)cudaErrorInvalidValue;
  if (k <= 0) return (int)cudaGetLastError();
  ColTable t;
  for (int c = 0; c < kMaxCols; ++c) {
    t.ptr[c] = c < n_cols ? cols[c] : nullptr;
    t.esize[c] = c < n_cols ? elem_sizes[c] : 0;
    if (c < n_cols && t.esize[c] != 8 && t.esize[c] != 4)
      return (int)cudaErrorInvalidValue;
  }
  int threads = R < kMaxThreads ? R : kMaxThreads;
  if (threads < 32) threads = 32;
  dim3 grid((unsigned)k, (unsigned)((n_cols + kColsPerBlock - 1) /
                                    kColsPerBlock));
  page_gather<<<grid, threads, 0, (cudaStream_t)stream>>>(
      t, n_cols, (const int32_t*)pages, (int64_t*)out, k, R, n_pages);
  return (int)cudaGetLastError();
}
