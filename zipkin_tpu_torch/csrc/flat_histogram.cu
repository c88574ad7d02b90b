// flat_histogram: counts[idx[i]] += w[i] for every row with 0 <= idx[i] < m.
//
// Replaces the TPU kernel zipkin_tpu/ops/pallas_kernels.py:flat_histogram
// (_hist_kernel), the primitive behind every counter, presence,
// latency-histogram and count-min update of the fused ingest step
// (zipkin_tpu/store/device.py:_scatter_add). On the TPU the count array
// sits in VMEM and a sequential grid adds row by row without atomics.
//
// What bounds it on an H100: memory. Each row reads 8 bytes (index and
// weight) and does one read-modify-write of a 4-byte count; the count
// arrays of the store (at most 1000 x 4096 int32 = 16 MB) stay resident
// in the 50 MB L2, so the atomics resolve in L2 and the stream of rows
// from device memory is the floor.
//
// Design: one thread per row, grid-stride, int32 atomicAdd into the
// global count array. Every caller passes integer weights, so the adds
// commute and the result is bitwise independent of the order the atomics
// land in. When the whole array fits a block's shared memory (the
// per-service count vectors), each block first accumulates a private
// copy there and then flushes its non-zero cells with one global atomic
// each, which takes the contention of hot services off L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kSmemCells = 12 * 1024;  // 48 KB of int32 cells

__global__ void hist_global(int32_t* __restrict__ counts,
                            const int32_t* __restrict__ idx,
                            const int32_t* __restrict__ w,
                            long long n, long long m) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    int32_t b = idx[i];
    if (b >= 0 && b < m) atomicAdd(&counts[b], w[i]);
  }
}

__global__ void hist_shared(int32_t* __restrict__ counts,
                            const int32_t* __restrict__ idx,
                            const int32_t* __restrict__ w,
                            long long n, int m) {
  extern __shared__ int32_t priv[];
  for (int j = threadIdx.x; j < m; j += blockDim.x) priv[j] = 0;
  __syncthreads();
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    int32_t b = idx[i];
    if (b >= 0 && b < m) atomicAdd(&priv[b], w[i]);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    int32_t v = priv[j];
    if (v != 0) atomicAdd(&counts[j], v);
  }
}

}  // namespace

// counts: int32 [m], updated in place; idx, w: int32 [n].
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int zt_flat_histogram(void* counts, const void* idx,
                                 const void* w, long long n, long long m,
                                 void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (m <= kSmemCells) {
    // Few blocks: each one flushes all m cells at its end.
    if (blocks > 264) blocks = 264;
    hist_shared<<<(unsigned)blocks, kThreads, (size_t)m * 4, s>>>(
        (int32_t*)counts, (const int32_t*)idx, (const int32_t*)w, n,
        (int)m);
  } else {
    if (blocks > 132 * 32) blocks = 132 * 32;
    hist_global<<<(unsigned)blocks, kThreads, 0, s>>>(
        (int32_t*)counts, (const int32_t*)idx, (const int32_t*)w, n, m);
  }
  return (int)cudaGetLastError();
}
