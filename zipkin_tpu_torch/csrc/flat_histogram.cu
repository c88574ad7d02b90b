// flat_histogram: up to eight flat int32 histograms in one launch. For
// each site k and every row i with 0 <= idx_k[i] < m_k,
// counts_k[idx_k[i]] += w_k[i] (1 where the site passes no weights);
// other rows are dropped.
//
// Replaces the TPU kernel zipkin_tpu/ops/pallas_kernels.py:flat_histogram
// (_hist_kernel), the primitive behind every counter, presence,
// latency-histogram and count-min update of the fused ingest step
// (zipkin_tpu/store/device.py:_scatter_add). On the TPU the count array
// sits in VMEM and a sequential grid adds row by row without atomics;
// the step calls it once a site. Here the step's seven sites are one
// launch.
//
// What bounds it on an H100: memory. A call must read each row's 4-byte
// index (and a 4-byte weight where the site passes weights) and
// read-modify-write each touched cell once:
//   bound = (sum over sites of rows x (4 B, + 4 B if weighted)
//            + touched cells x 8 B) / 3.35 TB/s,
// about 2.7 us for the ingest step's ~1.7 M rows. At that size the fixed
// cost of a launch, and of its grid's ramp, is most of the time.
//
// Design:
// - Launches: one grid serves all sites. The site table is a kernel
//   parameter (no copy to device memory); a block finds its site by
//   scanning the <= 8 first-block entries with static indices. Blocks
//   are shared out in proportion to rows: every site gets ceil(n / r)
//   blocks of r contiguous rows, r sized so the whole launch is about
//   4 blocks of 512 threads an SM.
// - Weights: a null weight pointer means weight 1, so the step's sites
//   read 4 bytes a row and need no tensor of ones.
// - Small arrays (m <= 4096 cells, 16 KB): the block adds into a private
//   copy in shared memory and flushes its non-zero cells with one global
//   atomic each. Such a block reads at least 2 x m rows (at the step's
//   1000-cell sites the launch's common share, 3,328 rows, is more).
//   Hot cells are what privatising saves: the two 1000-cell sites take
//   one global atomic for every few rows without it. A larger ratio
//   (8 or 16 x m rows a block) leaves those sites a handful of blocks
//   that each read their rows in many dependent rounds, and the launch
//   waits on them; their flush, <= m atomics onto cells that stay in
//   L2, costs less than those rounds (`chip_smoke.py --hist-variants`
//   times the ratios, the cap and the aggregation). The 16 KB cap keeps
//   the launch's one dynamic shared-memory size small, so every block
//   keeps its occupancy (4 x 16 KB an SM), and keeps a privatised
//   block's rows within a few times the common share.
// - Hot cells: rows of one warp that hit the same cell are grouped with
//   __match_any_sync; the group's lowest lane adds the group's summed
//   weight with one atomic (the weight count itself where all weights
//   are 1).
// - Each thread keeps 4 rows in flight (warp-strided, so every load is
//   one coalesced 128-byte line a warp) and streams them past L2
//   (__ldcs), where the count arrays stay.
// Every add is an int32 add, so the result is bitwise independent of the
// order in which atomics land.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSites = 8;
constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr long long kWarpRows = 32 * kUnroll;
constexpr long long kBlockRows = kThreads * kUnroll;
constexpr int kBlocksPerSm = 4;
constexpr long long kPrivCells = 4096;
constexpr long long kPrivRatio = 2;
constexpr bool kAggregate = true;  // false: one atomic a row
constexpr int kTableStride = 5;  // counts, m, idx, n, weights

struct Site {
  int32_t* counts;
  const int32_t* idx;
  const int32_t* w;  // null: every weight is 1
  long long n, m;
  long long rows;         // rows a block, a multiple of kWarpRows
  long long first_block;  // the site's first block in the grid
  int priv;               // 1: accumulate in shared memory first
};

struct Table {
  Site s[kMaxSites];
  int n_sites;
};

// Adds one row a lane (cell, w; `ok` false drops it) to dst.
__device__ __forceinline__ void add_row(int32_t* dst, int32_t cell,
                                        int32_t w, bool ok, bool weighted) {
  if (!kAggregate) {
    if (ok) atomicAdd(dst + cell, w);
    return;
  }
  unsigned peers = __match_any_sync(0xffffffffu, ok ? cell : -1);
  if (!ok) return;
  int32_t sum = __popc(peers);
  if (weighted) {
    sum = 0;
    for (unsigned p = peers; p; p &= p - 1)
      sum += __shfl_sync(peers, w, __ffs(p) - 1);
  }
  if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(dst + cell, sum);
}

__device__ __forceinline__ void add_rows(int32_t* dst, const Site& s,
                                         long long lo, long long hi) {
  const bool weighted = s.w != nullptr;
  const int lane = threadIdx.x & 31;
  // base is the same for the warp's lanes, so every lane of a warp takes
  // the same trips and __match_any_sync sees the full warp.
  for (long long base = lo + (threadIdx.x >> 5) * kWarpRows; base < hi;
       base += kBlockRows) {
    int32_t cell[kUnroll], w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long i = base + u * 32 + lane;
      cell[u] = i < hi ? __ldcs(s.idx + i) : -1;
      w[u] = (weighted && i < hi) ? __ldcs(s.w + i) : 1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      add_row(dst, cell[u], w[u], cell[u] >= 0 && cell[u] < s.m, weighted);
  }
}

__global__ void __launch_bounds__(kThreads)
    hist_multi(const __grid_constant__ Table t) {
  extern __shared__ int32_t priv[];
  // The block's site: the last one whose first block is <= blockIdx.x
  // (a site with no rows owns no block). Static indices only.
  Site s = t.s[0];
#pragma unroll
  for (int j = 1; j < kMaxSites; ++j)
    if (j < t.n_sites && blockIdx.x >= t.s[j].first_block) s = t.s[j];
  const long long lo = (blockIdx.x - s.first_block) * s.rows;
  const long long hi = lo + s.rows < s.n ? lo + s.rows : s.n;
  if (!s.priv) {
    add_rows(s.counts, s, lo, hi);
    return;
  }
  const int m = (int)s.m;
  for (int j = threadIdx.x; j < m; j += kThreads) priv[j] = 0;
  __syncthreads();
  add_rows(priv, s, lo, hi);
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += kThreads) {
    int32_t v = priv[j];
    if (v != 0) atomicAdd(s.counts + j, v);
  }
}

long long round_up(long long x, long long q) { return (x + q - 1) / q * q; }

}  // namespace

// sites: n_sites (1..8) rows of 5 values: counts pointer (int32 [m],
// updated in place), m, idx pointer (int32 [n]), n, weights pointer
// (int32 [n], or 0 for weight 1). One launch on `stream`, none when no
// site has a row. Returns cudaGetLastError() after the launch (0 =
// success).
extern "C" int zt_flat_histogram_multi(const long long* sites, int n_sites,
                                       void* stream) {
  if (n_sites < 1 || n_sites > kMaxSites) return (int)cudaErrorInvalidValue;
  Table t = {};
  t.n_sites = n_sites;
  long long total = 0;
  for (int k = 0; k < n_sites; ++k) {
    const long long* e = sites + k * kTableStride;
    if (e[1] < 0 || e[1] > INT32_MAX || e[3] < 0)
      return (int)cudaErrorInvalidValue;
    total += e[3];
  }
  if (total == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long target = (long long)(sms > 0 ? sms : 132) * kBlocksPerSm;
  long long r0 = (total + target - 1) / target;
  r0 = round_up(r0 > kBlockRows ? r0 : kBlockRows, kWarpRows);
  long long blocks = 0;
  size_t smem = 0;
  for (int k = 0; k < n_sites; ++k) {
    const long long* e = sites + k * kTableStride;
    Site& s = t.s[k];
    s.counts = (int32_t*)e[0];
    s.m = e[1];
    s.idx = (const int32_t*)e[2];
    s.n = e[3];
    s.w = (const int32_t*)e[4];
    s.priv = s.m <= kPrivCells;
    long long r = r0;
    if (s.priv && kPrivRatio * s.m > r)
      r = round_up(kPrivRatio * s.m, kWarpRows);
    s.rows = r;
    s.first_block = blocks;
    if (s.n == 0) continue;
    blocks += (s.n + r - 1) / r;
    if (s.priv && (size_t)s.m * 4 > smem) smem = (size_t)s.m * 4;
  }
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  hist_multi<<<(unsigned)blocks, kThreads, smem, st>>>(t);
  return (int)cudaGetLastError();
}
