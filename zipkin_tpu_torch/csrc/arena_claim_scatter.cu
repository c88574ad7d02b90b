// arena_claim_scatter: the FIFO slot claim plus the entry write of the
// unified index arena.
//
// Replaces the TPU kernel zipkin_tpu/ops/pallas_kernels.py:
// arena_claim_scatter (_arena_kernel). Per valid row, in arrival order,
// the TPU kernel claims slot = slot0 + ((base + cursor[bucket]++) &
// (depth - 1)) and writes the row's (gid, verify, ts) int64 triple, so an
// in-batch overflow row is overwritten by its newest successor. The
// final arena equals the rank-gated unique scatter of
// zipkin_tpu/store/device.py:_index_write: only the rows with
// rank >= cnt[bucket] - depth survive, at slot0 + ((base + rank) & (depth-1)).
//
// A GPU grid has no sequential order, and a per-bucket atomic cursor would
// hand out ranks in whatever order the atomics land, so the rank is
// derived instead, by the counting decomposition
//     rank(i) = prefix[tile(i), bucket(i)] + #{j < i in tile(i) : bucket(j) == bucket(i)}
// in three passes:
//   1. arena_count: per-(tile, bucket) row counts (int32 atomics; adds
//      commute, so the counts are exact);
//   2. arena_scan:  one thread per bucket turns its column into an
//      exclusive prefix over the tiles and records the bucket's total;
//   3. arena_write: each block of 256 rows counts its rows' same-bucket
//      predecessors inside the tile, chunk by chunk through shared
//      memory, then writes only the survivors. Survivors of one bucket
//      hold distinct ranks inside a window of depth, so their slots are
//      distinct: the stores are conflict-free and the result is bitwise
//      the arrival-order overwrite.
// The caller sizes the tiles so the [tiles, buckets] scratch stays
// within a fixed budget; fewer tiles mean longer in-tile scans.
//
// What bounds it on an H100: memory, at the batch sizes of the store:
// each row reads its 20 bytes of bucket, cursor, slot base, depth and
// valid flag plus its 24-byte value triple, and each survivor writes 24
// bytes at a hash-scattered arena slot. The in-tile scan is compute
// (tile/2 shared-memory compares a row); it grows with the tile and is
// what a later version should cut. Unlike the TPU kernel this one never
// holds the arena on chip, so it runs at any arena size: there is no
// VMEM-fit gate (pallas_kernels.arena_scatter_supported) on this card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 256;

__global__ void arena_count(const int32_t* __restrict__ bucket,
                            const uint8_t* __restrict__ valid,
                            int32_t* __restrict__ tc, long long n,
                            int n_buckets, long long tile) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    int32_t b = bucket[i];
    if (valid[i] && b >= 0 && b < n_buckets) {
      atomicAdd(&tc[(i / tile) * (long long)n_buckets + b], 1);
    }
  }
}

__global__ void arena_scan(int32_t* __restrict__ tc,
                           int32_t* __restrict__ cnt, int n_buckets,
                           int n_tiles) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_buckets) return;
  int32_t run = 0;
  for (int t = 0; t < n_tiles; ++t) {
    long long k = (long long)t * n_buckets + b;
    int32_t v = tc[k];
    tc[k] = run;
    run += v;
  }
  cnt[b] = run;
}

__global__ void arena_write(int64_t* __restrict__ entries,
                            const int32_t* __restrict__ bucket,
                            const int32_t* __restrict__ base,
                            const int64_t* __restrict__ slot0,
                            const int32_t* __restrict__ depth,
                            const int64_t* __restrict__ vals,
                            const uint8_t* __restrict__ valid,
                            const int32_t* __restrict__ prefix,
                            const int32_t* __restrict__ cnt, long long n,
                            int n_buckets, long long tile,
                            long long n_slots) {
  __shared__ int32_t sb[kRows];
  long long r0 = (long long)blockIdx.x * kRows;
  long long r = r0 + threadIdx.x;
  long long t = r0 / tile;
  long long ts = t * tile;
  int32_t my_b = -1;
  if (r < n && valid[r]) {
    int32_t b = bucket[r];
    if (b >= 0 && b < n_buckets) my_b = b;
  }
  int32_t w = 0;
  for (long long c = ts; c <= r0; c += kRows) {
    long long j = c + threadIdx.x;
    int32_t bj = -1;
    if (j < n && valid[j]) bj = bucket[j];
    sb[threadIdx.x] = bj;
    __syncthreads();
    if (my_b >= 0) {
      long long lim = r - c;
      int kmax = lim < kRows ? (int)lim : kRows;
      for (int k = 0; k < kmax; ++k) w += (sb[k] == my_b);
    }
    __syncthreads();
  }
  if (my_b < 0) return;
  int32_t rank = prefix[t * (long long)n_buckets + my_b] + w;
  int32_t d = depth[r];
  if (rank < cnt[my_b] - d) return;  // displaced within this batch
  uint32_t off = ((uint32_t)base[r] + (uint32_t)rank) & (uint32_t)(d - 1);
  long long slot = slot0[r] + (long long)off;
  if (slot < 0 || slot >= n_slots) return;
  entries[slot * 3 + 0] = vals[r * 3 + 0];
  entries[slot * 3 + 1] = vals[r * 3 + 1];
  entries[slot * 3 + 2] = vals[r * 3 + 2];
}

}  // namespace

// entries: int64 [n_slots, 3], updated in place. Per row (n rows):
// bucket, base, depth int32; slot0 int64; vals int64 [n, 3]; valid uint8.
// Scratch: tc int32 [n_tiles, n_buckets], cnt int32 [n_buckets].
// tile is a multiple of 256 and n_tiles = ceil(n / tile).
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int zt_arena_claim_scatter(
    void* entries, const void* bucket, const void* base, const void* slot0,
    const void* depth, const void* vals, const void* valid, void* tc,
    void* cnt, long long n, int n_buckets, int n_tiles, long long tile,
    long long n_slots, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(tc, 0, (size_t)n_tiles * (size_t)n_buckets * 4, s);
  long long blocks = (n + kRows - 1) / kRows;
  long long cblocks = blocks > 132 * 32 ? 132 * 32 : blocks;
  arena_count<<<(unsigned)cblocks, kRows, 0, s>>>(
      (const int32_t*)bucket, (const uint8_t*)valid, (int32_t*)tc, n,
      n_buckets, tile);
  arena_scan<<<(unsigned)((n_buckets + kRows - 1) / kRows), kRows, 0, s>>>(
      (int32_t*)tc, (int32_t*)cnt, n_buckets, n_tiles);
  arena_write<<<(unsigned)blocks, kRows, 0, s>>>(
      (int64_t*)entries, (const int32_t*)bucket, (const int32_t*)base,
      (const int64_t*)slot0, (const int32_t*)depth, (const int64_t*)vals,
      (const uint8_t*)valid, (const int32_t*)tc, (const int32_t*)cnt, n,
      n_buckets, tile, n_slots);
  return (int)cudaGetLastError();
}
