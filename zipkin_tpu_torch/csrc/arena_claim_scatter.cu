// arena_claim_scatter: the FIFO slot claim plus the entry write of the
// unified index arena, as two launches the ingest step calls apart.
//
// Replaces the TPU kernel zipkin_tpu/ops/pallas_kernels.py:
// arena_claim_scatter (_arena_kernel). Per valid row, in arrival order,
// the TPU kernel claims slot = slot0 + ((base + cursor[bucket]++) &
// (depth - 1)) and writes the row's (gid, verify, ts) int64 triple, so an
// in-batch overflow row is overwritten by its newest successor. The final
// arena equals the rank-gated unique scatter of
// zipkin_tpu/store/device.py:_index_write: only the rows with
// rank >= cnt[bucket] - depth survive, at slot0 + ((base + rank) & (depth-1)).
//
// The step needs each row's FIFO rank and each bucket's count before the
// write anyway (the displaced-entry gather and the watermarks read them),
// so the function is split in two:
//
//   zt_arena_claim -> (rank int32 [n], cnt int32 [n_buckets]):
//       key(i)  = bucket[i] for a valid row with bucket in [0, n_buckets),
//                 the sentinel n_buckets otherwise (a valid row outside
//                 that range is taken as invalid: it ranks among the
//                 invalid rows and counts nowhere);
//       rank(i) = #{j < i : key(j) == key(i)};  cnt[b] = #{i : key(i) == b}.
//   zt_arena_write: one thread a row; only the survivors store, at distinct
//       slots, so the stores never conflict and the arena is bitwise the
//       arrival-order overwrite.
//
// The claim is a stable LSD radix sort of (key, row), written by hand:
// keys take bit_length(n_buckets) bits (20 at 877,544 buckets; the
// sentinel of a power-of-two count needs the extra bit this gives), in
// 8-bit digits (256 bins), so 3 passes at the store's shapes. A pass is
//   1. per-block digit histograms in shared memory (a block = 4096 rows),
//      written digit-major as hist[digit][block];
//   2. one exclusive scan of hist (the block's first slot per digit);
//   3. a stable scatter: the block re-reads its rows in order, 256 at a
//      time; each warp ranks its lanes per digit with __match_any_sync and
//      the __popc of the lower lanes, earlier warps add their counts
//      through shared memory, and a running offset per digit carries the
//      rounds.
// Beside it, the bucket histogram (warp-aggregated atomics; the sentinel,
// which can hold most rows, one atomic a block) is cnt, and its exclusive
// scan is start; the last pass writes rank[row] = sorted_pos - start[key]
// instead of the sorted pairs. Stability through every pass makes the
// sorted order (key, row), so that difference is the arrival rank.
//
// What the earlier design did, and what this one does about it: it
// derived ranks from a dense [tiles, buckets] count matrix (capped at 2^26
// cells, 267 MB memset and walked one thread a bucket) plus an in-tile
// scan of up to ~27,600 same-tile predecessors a row (~2.9e10 shared
// compares a launch). Here the scratch is O(n + n_buckets) (two ping-pong
// (key, row) buffers, 256 histogram cells a block, the bucket starts) and
// no row looks at more than its own warp's lanes.
//
// What bounds it on an H100: memory. The claim must read each row's bucket
// and valid flag (5 B) and write its rank (4 B) and the counts (4 B a
// bucket); each radix pass moves ~16 B a row, so ~3 passes sit ~10x above
// that floor. The write reads a row's 24-byte triple and 25 bytes of rank,
// bucket, cursor, slot base, depth and flag, and stores 24 bytes a
// survivor at a hash-scattered slot. Unlike the TPU kernel this one never
// holds the arena on chip, so it runs at any arena size: there is no
// VMEM-fit gate (pallas_kernels.arena_scatter_supported) on this card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr long long kTile = (long long)kThreads * kItems;  // rows a block
constexpr int kBits = 8;
constexpr int kRadix = 1 << kBits;
constexpr int kScanItems = 4;
constexpr long long kScanTile = (long long)kThreads * kScanItems;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Keys, bucket counts and the first pass's digit histogram, one block a
// tile of kTile rows.
__global__ void arena_claim_keys(const int32_t* __restrict__ bucket,
                                 const uint8_t* __restrict__ valid,
                                 long long n, int n_buckets,
                                 int32_t* __restrict__ keys,
                                 int32_t* __restrict__ bcount,
                                 int32_t* __restrict__ hist, int n_blocks) {
  __shared__ int32_t s_hist[kRadix];
  __shared__ int32_t s_sent;
  for (int d = threadIdx.x; d < kRadix; d += kThreads) s_hist[d] = 0;
  if (threadIdx.x == 0) s_sent = 0;
  __syncthreads();
  const long long tile0 = (long long)blockIdx.x * kTile;
  for (int r = 0; r < kItems; ++r) {
    const long long i = tile0 + (long long)r * kThreads + threadIdx.x;
    const bool act = i < n;
    int32_t key = -1;
    if (act) {
      const int32_t b = bucket[i];
      key = (valid[i] && b >= 0 && b < n_buckets) ? b : n_buckets;
      keys[i] = key;
    }
    const unsigned peers = __match_any_sync(kFull, key);
    if (act && (peers & lanes_below()) == 0) {
      const int c = __popc(peers);
      if (key == n_buckets)
        atomicAdd(&s_sent, c);
      else
        atomicAdd(&bcount[key], c);
      atomicAdd(&s_hist[key & (kRadix - 1)], c);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_sent) atomicAdd(&bcount[n_buckets], s_sent);
  for (int d = threadIdx.x; d < kRadix; d += kThreads)
    hist[(long long)d * n_blocks + blockIdx.x] = s_hist[d];
}

// The digit histogram of a later pass.
__global__ void arena_claim_hist(const int32_t* __restrict__ keys,
                                 long long n, int shift,
                                 int32_t* __restrict__ hist, int n_blocks) {
  __shared__ int32_t s_hist[kRadix];
  for (int d = threadIdx.x; d < kRadix; d += kThreads) s_hist[d] = 0;
  __syncthreads();
  const long long tile0 = (long long)blockIdx.x * kTile;
  for (int r = 0; r < kItems; ++r) {
    const long long i = tile0 + (long long)r * kThreads + threadIdx.x;
    const bool act = i < n;
    const int d = act ? (keys[i] >> shift) & (kRadix - 1) : -1;
    const unsigned peers = __match_any_sync(kFull, d);
    if (act && (peers & lanes_below()) == 0)
      atomicAdd(&s_hist[d], __popc(peers));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kRadix; d += kThreads)
    hist[(long long)d * n_blocks + blockIdx.x] = s_hist[d];
}

// One stable scatter pass (see the header). rows_in == nullptr is the
// identity order of the first pass. With rank != nullptr (the last pass)
// it writes rank[row] = pos - start[key] and no sorted pairs.
__global__ void arena_claim_rank(const int32_t* __restrict__ keys_in,
                                 const int32_t* __restrict__ rows_in,
                                 long long n, int shift,
                                 const int32_t* __restrict__ offs,
                                 int n_blocks,
                                 int32_t* __restrict__ keys_out,
                                 int32_t* __restrict__ rows_out,
                                 const int32_t* __restrict__ start,
                                 int32_t* __restrict__ rank) {
  __shared__ int32_t s_off[kRadix];
  __shared__ int32_t s_wc[kWarps][kRadix];
  for (int d = threadIdx.x; d < kRadix; d += kThreads) {
    s_off[d] = offs[(long long)d * n_blocks + blockIdx.x];
    for (int w = 0; w < kWarps; ++w) s_wc[w][d] = 0;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const long long tile0 = (long long)blockIdx.x * kTile;
  for (int r = 0; r < kItems; ++r) {
    const long long i = tile0 + (long long)r * kThreads + threadIdx.x;
    const bool act = i < n;
    int32_t key = 0, row = 0, d = -1;
    if (act) {
      key = keys_in[i];
      row = rows_in ? rows_in[i] : (int32_t)i;
      d = (key >> shift) & (kRadix - 1);
    }
    const unsigned peers = __match_any_sync(kFull, d);
    const bool leader = act && (peers & lanes_below()) == 0;
    const int c = __popc(peers);
    if (leader) s_wc[warp][d] = c;
    __syncthreads();
    if (act) {
      int32_t pos = s_off[d] + __popc(peers & lanes_below());
      for (int w = 0; w < warp; ++w) pos += s_wc[w][d];
      if (rank) {
        rank[row] = pos - start[key];
      } else {
        keys_out[pos] = key;
        rows_out[pos] = row;
      }
    }
    __syncthreads();
    if (leader) {
      atomicAdd(&s_off[d], c);
      s_wc[warp][d] = 0;
    }
    __syncthreads();
  }
}

// Exclusive scan of kScanTile elements a block (out may equal in); the
// block's total goes to sums[block] when sums is given.
__global__ void arena_claim_scan(const int32_t* in, int32_t* out,
                                 long long len, int32_t* sums) {
  __shared__ int32_t s_warp[kWarps];
  const long long i0 =
      (long long)blockIdx.x * kScanTile + (long long)threadIdx.x * kScanItems;
  int32_t v[kScanItems];
  int32_t t = 0;
  for (int j = 0; j < kScanItems; ++j) {
    v[j] = i0 + j < len ? in[i0 + j] : 0;
    t += v[j];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t x = t;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < kWarps ? s_warp[lane] : 0;
    for (int o = 1; o < kWarps; o <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  int32_t run = x - t + (warp > 0 ? s_warp[warp - 1] : 0);
  for (int j = 0; j < kScanItems; ++j) {
    if (i0 + j < len) out[i0 + j] = run;
    run += v[j];
  }
  if (sums && threadIdx.x == kThreads - 1) sums[blockIdx.x] = run;
}

__global__ void arena_claim_scan_add(int32_t* __restrict__ out, long long len,
                                     const int32_t* __restrict__ sums) {
  const int32_t add = sums[blockIdx.x];
  const long long i0 = (long long)blockIdx.x * kScanTile;
  for (int j = threadIdx.x; j < kScanTile; j += kThreads)
    if (i0 + j < len) out[i0 + j] += add;
}

long long scan_scratch(long long len) {
  long long total = 0;
  for (long long nb = (len + kScanTile - 1) / kScanTile; nb > 1;
       nb = (nb + kScanTile - 1) / kScanTile)
    total += nb;
  return total;
}

void scan_excl(const int32_t* in, int32_t* out, long long len, int32_t* sums,
               cudaStream_t s) {
  const long long nb = (len + kScanTile - 1) / kScanTile;
  if (nb <= 1) {
    arena_claim_scan<<<1, kThreads, 0, s>>>(in, out, len, nullptr);
    return;
  }
  arena_claim_scan<<<(unsigned)nb, kThreads, 0, s>>>(in, out, len, sums);
  scan_excl(sums, sums, nb, sums + nb, s);
  arena_claim_scan_add<<<(unsigned)nb, kThreads, 0, s>>>(out, len, sums);
}

__global__ void arena_write_rows(int64_t* __restrict__ entries,
                                 const int32_t* __restrict__ rank,
                                 const int32_t* __restrict__ cnt,
                                 const int32_t* __restrict__ bucket,
                                 const int32_t* __restrict__ base,
                                 const int64_t* __restrict__ slot0,
                                 const int32_t* __restrict__ depth,
                                 const int64_t* __restrict__ vals,
                                 const uint8_t* __restrict__ valid,
                                 long long n, int n_buckets,
                                 long long n_slots) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n || !valid[r]) return;
  const int32_t b = bucket[r];
  if (b < 0 || b >= n_buckets) return;
  const int32_t k = rank[r];
  const int32_t d = depth[r];
  if (k < cnt[b] - d) return;  // displaced within this batch
  const uint32_t off = ((uint32_t)base[r] + (uint32_t)k) & (uint32_t)(d - 1);
  const long long slot = slot0[r] + (long long)off;
  if (slot < 0 || slot >= n_slots) return;
  entries[slot * 3 + 0] = vals[r * 3 + 0];
  entries[slot * 3 + 1] = vals[r * 3 + 1];
  entries[slot * 3 + 2] = vals[r * 3 + 2];
}

int bit_length(long long x) {
  int b = 0;
  while (x > 0) {
    ++b;
    x >>= 1;
  }
  return b;
}

}  // namespace

// int32 elements of scratch zt_arena_claim needs for n rows.
extern "C" long long zt_arena_claim_scratch(long long n, int n_buckets) {
  const long long blocks = (n + kTile - 1) / kTile;
  const long long hist = (long long)kRadix * blocks;
  const long long a = scan_scratch(hist), b = scan_scratch(n_buckets + 1LL);
  return 4 * n + hist + (n_buckets + 1LL) + (a > b ? a : b);
}

// bucket int32 [n], valid uint8 [n] -> rank int32 [n], cnt int32
// [n_buckets + 1] (the last cell counts the sentinel rows). 0 < n < 2^31,
// 0 < n_buckets < 2^31 - 1. Returns cudaGetLastError() after the launches
// (0 = success).
extern "C" int zt_arena_claim(const void* bucket, const void* valid,
                              long long n, int n_buckets, void* rank,
                              void* cnt, void* scratch, void* stream) {
  if (n <= 0 || n_buckets <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long blocks = (n + kTile - 1) / kTile;
  const int nb = (int)blocks;
  const long long hist_len = (long long)kRadix * blocks;
  int32_t* ka = (int32_t*)scratch;
  int32_t* ra = ka + n;
  int32_t* kb = ra + n;
  int32_t* rb = kb + n;
  int32_t* hist = rb + n;
  int32_t* start = hist + hist_len;
  int32_t* sums = start + n_buckets + 1;
  int32_t* count = (int32_t*)cnt;
  const long long cells = n_buckets + 1LL;
  const cudaError_t z = cudaMemsetAsync(count, 0, cells * sizeof(int32_t), s);
  if (z != cudaSuccess) return (int)z;
  arena_claim_keys<<<nb, kThreads, 0, s>>>(
      (const int32_t*)bucket, (const uint8_t*)valid, n, n_buckets, ka, count,
      hist, nb);
  scan_excl(count, start, cells, sums, s);
  const int passes = (bit_length(n_buckets) + kBits - 1) / kBits;
  const int32_t* kin = ka;
  const int32_t* rin = nullptr;
  int32_t* kout = kb;
  int32_t* rout = rb;
  for (int p = 0; p < passes; ++p) {
    if (p > 0)
      arena_claim_hist<<<nb, kThreads, 0, s>>>(kin, n, p * kBits, hist, nb);
    scan_excl(hist, hist, hist_len, sums, s);
    const bool last = p == passes - 1;
    arena_claim_rank<<<nb, kThreads, 0, s>>>(
        kin, rin, n, p * kBits, hist, nb, last ? nullptr : kout,
        last ? nullptr : rout, start, last ? (int32_t*)rank : nullptr);
    kin = kout;
    rin = rout;
    kout = kout == kb ? ka : kb;
    rout = rout == rb ? ra : rb;
  }
  return (int)cudaGetLastError();
}

// entries: int64 [n_slots, 3], updated in place. Per row (n rows): rank,
// bucket, base, depth int32; slot0 int64; vals int64 [n, 3]; valid uint8.
// cnt: int32 [n_buckets]. Returns cudaGetLastError() after the launch.
extern "C" int zt_arena_write(void* entries, const void* rank,
                              const void* cnt, const void* bucket,
                              const void* base, const void* slot0,
                              const void* depth, const void* vals,
                              const void* valid, long long n, int n_buckets,
                              long long n_slots, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const long long blocks = (n + kThreads - 1) / kThreads;
  arena_write_rows<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (int64_t*)entries, (const int32_t*)rank, (const int32_t*)cnt,
      (const int32_t*)bucket, (const int32_t*)base, (const int64_t*)slot0,
      (const int32_t*)depth, (const int64_t*)vals, (const uint8_t*)valid, n,
      n_buckets, n_slots);
  return (int)cudaGetLastError();
}
