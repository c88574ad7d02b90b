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
// What bounds it on an H100: memory. A live page moves R x (11 x 8 + 3 x 4)
// bytes in and R x 14 x 8 bytes out; there is no arithmetic. At the store's
// read shapes (K <= a few hundred pages of 128 rows) that is a few MB (12.8
// MB, 3.8 us at 3.35 TB/s, for 512 pages). Every line the call brings into
// L2 evicts another; where that one was written (the store's steps write
// gigabytes), the eviction is a write-back the bound does not count.
//
// Design:
// - One warp a (requested page, column), eight warps a block, a block's
//   warps on neighbouring columns of one page: at 512 pages x 14 columns,
//   896 blocks, all resident at once.
// - 16-byte accesses: an int64 column moves two rows a load and a store
//   (longlong2); an int32 column four rows a load (int4), sign-extended
//   into two 16-byte int64 stores; a hole page writes zeros 16 bytes a
//   store. A lane keeps up to kUnroll loads in flight. Plain loads and
//   stores: streaming hints (__ldcs / __stcs) measured the same with the
//   L2 cold and a tenth slower with it warm. 8-byte copies (one element
//   a lane a step) and a block's warps on one column both measured slower
//   (PERF.md, "paged_page_gather"); `chip_smoke.py --gather-variants`
//   times kUnroll and kThreads.
// - Alignment: a column's page starts p x R x 4 or 8 bytes past its base,
//   a multiple of 16 for R % 4 == 0 (the wrapper takes powers of two
//   >= 8), and the output rows start at multiples of R x 8 bytes of a
//   fresh allocation. So the vector path holds whenever a column's base is
//   16-byte aligned; a warp whose column (or output) is not, or an R that
//   is not a multiple of 4, copies one element a lane a step instead. The
//   check is per warp, in the kernel.
// No shared memory, no atomics; warps are independent, so the result does
// not depend on their order. The wrapper validates a column set once and
// keeps its pointer table (zipkin_tpu_torch/ops/kernels.py:_gather_table),
// so a repeat call is one check of ``pages``, one allocation and this
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

struct ColTable {
  const void* ptr[kMaxCols];
  int esize[kMaxCols];
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// dst[0 .. units) = src[0 .. units), 16 bytes a unit, by one warp.
__device__ __forceinline__ void copy_units(const longlong2* src,
                                           longlong2* dst, int units,
                                           int lane) {
  for (int j0 = lane; j0 < units; j0 += 32 * kUnroll) {
    longlong2 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j0 + 32 * u < units) v[u] = src[j0 + 32 * u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j0 + 32 * u < units) dst[j0 + 32 * u] = v[u];
  }
}

// Sign-extends units x 4 int32 rows of src into dst, by one warp: a unit
// is one 16-byte load and two 16-byte stores.
__device__ __forceinline__ void widen_units(const int4* src, longlong2* dst,
                                            int units, int lane) {
  for (int j0 = lane; j0 < units; j0 += 32 * kUnroll) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j0 + 32 * u < units) v[u] = src[j0 + 32 * u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + 32 * u;
      if (j < units) {
        dst[2 * j] = make_longlong2(v[u].x, v[u].y);
        dst[2 * j + 1] = make_longlong2(v[u].z, v[u].w);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    page_gather(const __grid_constant__ ColTable t, int n_cols,
                const int32_t* __restrict__ pages, int64_t* __restrict__ out,
                int k, int R, long long n_pages) {
  const long long wid = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (wid >= (long long)k * n_cols) return;
  const int lane = threadIdx.x & 31;
  const int i = (int)(wid / n_cols);
  const int c = (int)(wid % n_cols);
  const int32_t p = __ldg(pages + i);
  const bool hole = p < 0 || (long long)p >= n_pages;
  int64_t* dst = out + (long long)c * k * R + (long long)i * R;
  const bool wide = t.esize[c] == 8;
  const void* base = t.ptr[c];
  const bool vec = (R & 3) == 0 && aligned16(dst) && aligned16(base);
  const long long src0 = (long long)p * R;
  if (hole) {
    if (vec) {
      longlong2* d2 = reinterpret_cast<longlong2*>(dst);
      for (int j = lane; j < R / 2; j += 32)
        d2[j] = make_longlong2(0, 0);
    } else {
      for (int j = lane; j < R; j += 32) dst[j] = 0;
    }
  } else if (vec && wide) {
    copy_units(reinterpret_cast<const longlong2*>(
                   static_cast<const int64_t*>(base) + src0),
               reinterpret_cast<longlong2*>(dst), R / 2, lane);
  } else if (vec) {
    widen_units(reinterpret_cast<const int4*>(
                    static_cast<const int32_t*>(base) + src0),
                reinterpret_cast<longlong2*>(dst), R / 4, lane);
  } else if (wide) {
    const int64_t* src = static_cast<const int64_t*>(base) + src0;
    for (int j = lane; j < R; j += 32) dst[j] = src[j];
  } else {
    const int32_t* src = static_cast<const int32_t*>(base) + src0;
    for (int j = lane; j < R; j += 32) dst[j] = (int64_t)src[j];
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
  const long long blocks = ((long long)k * n_cols + kWarps - 1) / kWarps;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  page_gather<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      t, n_cols, (const int32_t*)pages, (int64_t*)out, k, R, n_pages);
  return (int)cudaGetLastError();
}
