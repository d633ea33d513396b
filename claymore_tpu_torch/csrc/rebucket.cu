// The full rebucket on the card: core/partition.py:sort_permute, the
// stable key sort included.
//
// Replaces no Pallas kernel: the JAX package runs this stage in XLA
// (claymore_tpu/core/partition.py:83 sort_permute, one lax.sort carrying
// every channel at :147, then a searchsorted over the monotone destination
// slots and one window slice per tile).  The port's plain version
// (core/partition.py: home_keys, sort_keys' torch.sort, segment_heads,
// segment_bases, tile_windows, place) is what each kernel here is held
// against, bit for bit: the stage only moves data and does integer
// arithmetic.
//
// Bound: device memory.  The sort: each key read, each sorted key and slot
// index written, 12 bytes a slot.  Beyond it, an active slot's position (12
// bytes) for its key, its sorted key (4), its sort index (4) and every
// 4-byte channel (position 3, the material's fields, the id) read once;
// every slot's active flag read (1), its key written (4), every channel
// written and its new flag written: 26 + 8 C bytes a slot for C channels
// when all are active, 130 for FixedCorotated
// (utils/bounds.py:rebucket_bound).  Everything else scales with the block
// segments (at most one per occupied block), not the slots.
//
// Design.  The destination slot of sorted element i in block segment g is
// base[g] + (i - seg_start[g]): monotone in i, so each destination tile is
// one contiguous window of sorted indices.  Five stages, each a plain C
// entry point:
// * cm_rebucket_keys, one thread a slot: its home-block key from its
//   position (12 bytes in, 4 out), the sentinel for an inactive slot;
// * cm_rebucket_sort, the stable sort of the keys, this package's own: an
//   LSD radix sort of the active slots alone (key below the sentinel),
//   over the bit_length(sentinel - 1) bits they need, in the fewest
//   passes of at most 10-bit digits (18 bits in 2 passes of 9 at a 64^3
//   block grid), carrying int32 slot indices.  torch.sort sorts every slot
//   over all 32 bits with an int64 index.  Each pass is a count, a scan and
//   a scatter over CTA chunks of kSortChunk keys: the count kernel takes a
//   histogram of the chunk's digits (a warp's equal digits found by one
//   vote where the whole warp agrees, as it mostly does on slots near key
//   order, else by __match_any_sync; one shared atomic each); one CTA a
//   digit scans that digit's counts over the chunks in place (digit-major,
//   so each digit's row is contiguous); the scatter kernel starts each digit of its chunk
//   at the digits below it plus its own row's prefix, ranks each tile of
//   kSortTile keys stably (per-warp digit counters, a warp's keys in item
//   then lane order, the warps in order) and writes every key and index
//   to its destination.  The first pass reads the keys from every slot and
//   takes the inactive ones as one more digit after the rest: their
//   indices go, in slot order, straight into perm's tail and their keys
//   into skey's, and the active count (the tail's start) is written for
//   the later passes, which cover the active pairs alone and launch over
//   every slot's chunks, the chunks past the count leaving at once.  The
//   last pass writes skey[0, A) and perm[0, A).  With A active of S slots
//   and P passes the sort moves 16 S + 20 A (P - 1) bytes (1.6 GB at
//   sphere25m's 69.6M slots, 25.1M active; torch.sort ~7 GB).
// * cm_rebucket_heads, over the S sorted keys, a two-level scan: per-CTA
//   head counts, one CTA scanning the CTA totals, a CTA-local pass that
//   writes seg_start[g] (a head: an active key unlike the one before it)
//   and, after the last head, seg_start[G] = the active count (the active
//   keys are a prefix: the sentinel sorts last).  All int32: S < 2^31.
// * cm_rebucket_plan, over the G segments (a fixed grid of kSegCtas CTAs,
//   each a contiguous share of the G it reads on the device): each oct head
//   (the segment whose key >> 3 differs from the one before) sums its at
//   most 8 segments' tile-padded lengths and pads that span to a multiple
//   of group_tiles tiles; a two-level scan of those spans gives each oct's
//   base, and the head writes its segments' bases (int64), adding the
//   elements past the capacity to `dropped`.  Then one thread a
//   destination tile binary-searches the bases for the segment its first
//   slot lies in: its window (dstart, dlen) and its block key.
// * cm_rebucket_place, one thread a destination slot: a slot inside its
//   tile's window gathers every channel from perm[dstart + j] (all loads
//   issued before any store), any other slot writes the fills.  Writes are
//   coalesced; reads are as coalesced as the old slots were in key order.
//   The channels' pointers travel in the kernel's parameters.

#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace rebucket {

using cm_scan::block_exclusive;
using cm_scan::scan_serial;

constexpr int kThreads = 256;
constexpr int kRounds = 8;                     // heads: rounds of kThreads keys a CTA
constexpr int kChunk = kThreads * kRounds;     // sorted keys a CTA
constexpr int kScanThreads = 1024;
constexpr int kSegCtas = 512;                  // the segment pass's grid
constexpr int kMaxChannels = 16;
constexpr int kWarps = kThreads / 32;
constexpr int kSortItems = 24;                     // sort: keys a thread a tile
constexpr int kSortTile = kThreads * kSortItems;   // keys a tile
constexpr int kSortTiles = 3;                      // tiles a CTA
constexpr int kSortChunk = kSortTile * kSortTiles; // keys a CTA of each pass
constexpr int kScanGroup = 8;                      // sort: counts a scan thread loads at once
constexpr int kMaxDigitBits = 10;
constexpr int kMaxBuckets = (1 << kMaxDigitBits) + 1;   // a digit's values, the inactive slots

// ---------------------------------------------------------------- keys

// core/partition.py:home_keys: floor(x dx_inv + 0.5) - 1 is the stencil's
// base cell, (base - 1) >> block_bits the home block; rounded as torch
// rounds each op (no contraction) and converted as its CUDA kernels convert
// (cvt.rzi, saturating), the integer steps in wrapping 32-bit arithmetic.
__global__ void __launch_bounds__(kThreads)
keys_kernel(const float* __restrict__ pos, const unsigned char* __restrict__ active, int n,
            float dx_inv, int block_bits, int g, int* __restrict__ key) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int n3 = g * g * g;
  int k = n3;
  if (active[i]) {
    int c[3];
    bool valid = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float x = __fadd_rn(__fmul_rn(pos[(long long)a * n + i], dx_inv), 0.5f);
      const int cell = (int)floorf(x);
      c[a] = (int)((unsigned)cell - 2u) >> block_bits;
      valid = valid && c[a] >= 0 && c[a] < g;
    }
    if (valid) k = (c[0] * g + c[1]) * g + c[2];
  }
  key[i] = k;
}

// ---------------------------------------------------------------- sort

// One pass of the sort: its keys and slots in and out, its digit.  In the
// first pass the slot is the position and a key at or above the sentinel
// is inactive: the last bucket, which goes to skey's and perm's tails.
struct SortPass {
  const int* key_in;
  const int* val_in;     // unused in the first pass
  int* key_out;
  int* val_out;
  int* skey;             // the first pass's inactive slots
  int* perm;
  const int* count;      // the keys of a later pass: the active count
  int n;                 // the first pass's keys: the slots
  int shift, width;
  int sentinel;
};

template <bool First>
__device__ __forceinline__ int pass_keys(const SortPass& p) {
  return First ? p.n : *p.count;
}

template <bool First>
__device__ __forceinline__ int pass_buckets(const SortPass& p) {
  return (1 << p.width) + (First ? 1 : 0);
}

template <bool First>
__device__ __forceinline__ int bucket_of(const SortPass& p, int key) {
  if (First && key >= p.sentinel) return 1 << p.width;
  return (key >> p.shift) & ((1 << p.width) - 1);
}

// The lanes of the warp whose bucket equals this lane's: all of them when
// the warp agrees (the common case: slots near key order), else
// __match_any_sync's answer.
__device__ __forceinline__ unsigned same_bucket(int b) {
  if (__all_sync(0xffffffffu, b == __shfl_sync(0xffffffffu, b, 0))) return 0xffffffffu;
  return __match_any_sync(0xffffffffu, b);
}

// A thread's item i of a tile lies at item_offset() + 32 i: in a tile,
// warp w holds kSortItems rounds of 32 consecutive keys, the warps in order.
__device__ __forceinline__ int item_offset() {
  return (threadIdx.x >> 5) * (kSortItems * 32) + (threadIdx.x & 31);
}

// counts[b * nb + c]: the keys of bucket b in chunk c
template <bool First>
__global__ void __launch_bounds__(kThreads)
sort_count_kernel(SortPass p, int nb, int* __restrict__ counts) {
  __shared__ int hist[kMaxBuckets];
  const int n = pass_keys<First>(p);
  const long long chunk0 = (long long)blockIdx.x * kSortChunk;
  if (chunk0 >= n) return;
  const int buckets = pass_buckets<First>(p);
  const int lane = threadIdx.x & 31, off = item_offset();
  for (int b = threadIdx.x; b < buckets; b += kThreads) hist[b] = 0;
  __syncthreads();
  for (int t = 0; t < kSortTiles; ++t) {
    const long long tile0 = chunk0 + (long long)t * kSortTile;
    if (tile0 >= n) break;
    const int rem = (int)min((long long)kSortTile, n - tile0);
    const int* in = p.key_in + tile0;
    int key[kSortItems];
#pragma unroll
    for (int i = 0; i < kSortItems; ++i) key[i] = off + 32 * i < rem ? in[off + 32 * i] : 0;
#pragma unroll
    for (int i = 0; i < kSortItems; ++i) {
      const bool valid = off + 32 * i < rem;
      const int b = valid ? bucket_of<First>(p, key[i]) : buckets;
      const unsigned same = same_bucket(b);
      if (valid && lane == __ffs(same) - 1) atomicAdd(&hist[b], __popc(same));
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < buckets; b += kThreads)
    counts[(long long)b * nb + blockIdx.x] = hist[b];
}

// one CTA a bucket: its row of chunk counts scanned in place, its total;
// each thread a contiguous run, its loads issued kScanGroup at a time
__global__ void __launch_bounds__(kThreads)
sort_scan_kernel(const int* __restrict__ count, int n, int nb, int* counts,
                 int* __restrict__ totals) {
  const int keys = count ? *count : n;
  const int used = (int)(((long long)keys + kSortChunk - 1) / kSortChunk);
  int* row = counts + (long long)blockIdx.x * nb;
  const int per = (used + kThreads - 1) / kThreads;
  const int lo = min(used, (int)threadIdx.x * per), hi = min(used, lo + per);
  int s = 0;
  for (int g = lo; g < hi; g += kScanGroup) {
    int v[kScanGroup];
#pragma unroll
    for (int k = 0; k < kScanGroup; ++k) v[k] = g + k < hi ? row[g + k] : 0;
#pragma unroll
    for (int k = 0; k < kScanGroup; ++k) s += v[k];
  }
  int total;
  int run = block_exclusive(s, &total);
  for (int g = lo; g < hi; g += kScanGroup) {
    int v[kScanGroup];
#pragma unroll
    for (int k = 0; k < kScanGroup; ++k) v[k] = g + k < hi ? row[g + k] : 0;
#pragma unroll
    for (int k = 0; k < kScanGroup; ++k) {
      if (g + k < hi) row[g + k] = run;
      run += v[k];
    }
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// Each key of the chunk to its destination: the keys of the buckets below
// it, of its bucket in the chunks before, in the tiles before, in the
// warps before, then its rank in its warp.  The first pass writes the
// active count (where the inactive bucket starts) and adds it to *pairs.
template <bool First>
__global__ void __launch_bounds__(kThreads, 2)
sort_scatter_kernel(SortPass p, int nb, const int* __restrict__ counts,
                    const int* __restrict__ totals, int* __restrict__ active,
                    long long* __restrict__ pairs) {
  __shared__ int cnt[kWarps][kMaxBuckets + 1];   // a tile's per-warp counts, then starts
  __shared__ int next[kMaxBuckets];               // each bucket's next destination
  const int n = pass_keys<First>(p);
  const long long chunk0 = (long long)blockIdx.x * kSortChunk;
  if (chunk0 >= n) return;
  const int buckets = pass_buckets<First>(p);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, off = item_offset();
  {
    const int per = (buckets + kThreads - 1) / kThreads;
    const int lo = min(buckets, (int)threadIdx.x * per), hi = min(buckets, lo + per);
    int s = 0;
    for (int b = lo; b < hi; ++b) s += totals[b];
    int all;
    int run = block_exclusive(s, &all);
    for (int b = lo; b < hi; ++b) {
      next[b] = run + counts[(long long)b * nb + blockIdx.x];
      if (First && b == buckets - 1 && blockIdx.x == 0) {
        *active = run;
        atomicAdd(reinterpret_cast<unsigned long long*>(pairs), (unsigned long long)run);
      }
      run += totals[b];
    }
  }
  const unsigned below = (1u << lane) - 1u;
  for (int t = 0; t < kSortTiles; ++t) {
    const long long tile0 = chunk0 + (long long)t * kSortTile;
    if (tile0 >= n) break;
    const int rem = (int)min((long long)kSortTile, n - tile0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      for (int j = threadIdx.x; j <= buckets; j += kThreads) cnt[w][j] = 0;
    int key[kSortItems], val[kSortItems], slot[kSortItems];   // slot: bucket | rank << 16
#pragma unroll
    for (int i = 0; i < kSortItems; ++i) {
      const int o = off + 32 * i;
      key[i] = o < rem ? p.key_in[tile0 + o] : 0;
      if (!First) val[i] = o < rem ? p.val_in[tile0 + o] : 0;
    }
    __syncthreads();                              // the zeroed counters
#pragma unroll
    for (int i = 0; i < kSortItems; ++i) {
      const int b = off + 32 * i < rem ? bucket_of<First>(p, key[i]) : buckets;
      const unsigned same = same_bucket(b);
      const int before = cnt[warp][b];
      __syncwarp();
      if (lane == __ffs(same) - 1) cnt[warp][b] = before + __popc(same);
      __syncwarp();
      slot[i] = b | ((before + __popc(same & below)) << 16);
    }
    __syncthreads();
    for (int b = threadIdx.x; b < buckets; b += kThreads) {
      int run = next[b];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = cnt[w][b];
        cnt[w][b] = run;
        run += c;
      }
      next[b] = run;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kSortItems; ++i) {
      const int b = slot[i] & 0xffff;
      if (b == buckets) continue;                 // past the keys
      const int dest = cnt[warp][b] + (slot[i] >> 16);
      const int v = First ? (int)(tile0 + off + 32 * i) : val[i];
      if (First && b == buckets - 1) {
        p.skey[dest] = key[i];
        p.perm[dest] = v;
      } else {
        p.key_out[dest] = key[i];
        p.val_out[dest] = v;
      }
    }
    __syncthreads();                              // before the next tile's zeroing
  }
}

// ---------------------------------------------------------------- heads

__global__ void __launch_bounds__(kThreads)
heads_count_kernel(const int* __restrict__ skey, int n, int sentinel,
                   int* __restrict__ cta_count) {
  const long long base = (long long)blockIdx.x * kChunk;
  int c = 0;
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + r * kThreads + threadIdx.x;
    if (i < n) {
      const int k = skey[i];
      c += (k < sentinel && (i == 0 || skey[i - 1] != k)) ? 1 : 0;
    }
  }
  int total;
  block_exclusive(c, &total);
  if (threadIdx.x == 0) cta_count[blockIdx.x] = total;
}

// meta = (G, active count); seg_start[0] = 0 when nothing is active
__global__ void __launch_bounds__(kScanThreads)
heads_scan_kernel(const int* __restrict__ cta_count, int nb, int* __restrict__ cta_off,
                  int* __restrict__ meta, int* __restrict__ seg_start) {
  const int g = scan_serial(cta_count, nb, cta_off);
  if (threadIdx.x == 0) {
    meta[0] = g;
    meta[1] = 0;
    if (g == 0) seg_start[0] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
heads_write_kernel(const int* __restrict__ skey, int n, int sentinel,
                   const int* __restrict__ cta_off, int* __restrict__ meta,
                   int* __restrict__ seg_start) {
  const long long base = (long long)blockIdx.x * kChunk;
  int carry = cta_off[blockIdx.x];
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + r * kThreads + threadIdx.x;
    int head = 0;
    if (i < n) {
      const int k = skey[i];
      if (k < sentinel) {
        head = (i == 0 || skey[i - 1] != k) ? 1 : 0;
        if (i + 1 == n || skey[i + 1] >= sentinel) {     // the last active key
          meta[1] = (int)(i + 1);
          seg_start[meta[0]] = (int)(i + 1);
        }
      }
    }
    int total;
    const int rank = block_exclusive(head, &total);
    if (head) seg_start[carry + rank] = (int)i;
    carry += total;
  }
}

// ---------------------------------------------------------------- plan

__device__ __forceinline__ int seg_oct(const int* skey, const int* start, int g) {
  return skey[start[g]] >> 3;
}

__device__ __forceinline__ long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ bool oct_head(const int* skey, const int* start, int g) {
  return g == 0 || seg_oct(skey, start, g) != seg_oct(skey, start, g - 1);
}

// the tile-padded span of the oct whose first segment is g, and its
// segment count (at most 8: the oct's blocks)
__device__ long long oct_span(const int* skey, const int* start, int g_count, int g,
                              int tile, int* nseg) {
  const int o = seg_oct(skey, start, g);
  long long span = 0;
  int k = g;
  do {
    span += round_up(start[k + 1] - start[k], tile);
    ++k;
  } while (k < g_count && seg_oct(skey, start, k) == o);
  *nseg = k - g;
  return span;
}

// this CTA's share [lo, hi) of the G segments
__device__ __forceinline__ void seg_share(int g_count, int* lo, int* hi) {
  const int per = (g_count + gridDim.x - 1) / gridDim.x;
  *lo = min(g_count, (int)blockIdx.x * per);
  *hi = min(g_count, *lo + per);
}

__global__ void __launch_bounds__(kThreads)
seg_count_kernel(const int* __restrict__ skey, const int* __restrict__ start,
                 const int* __restrict__ meta, int tile, long long group,
                 long long* __restrict__ cta_sum) {
  const int g_count = meta[0];
  int lo, hi;
  seg_share(g_count, &lo, &hi);
  long long s = 0;
  for (int g = lo + threadIdx.x; g < hi; g += blockDim.x) {
    if (oct_head(skey, start, g)) {
      int nseg;
      s += round_up(oct_span(skey, start, g_count, g, tile, &nseg), group);
    }
  }
  long long total;
  block_exclusive(s, &total);
  if (threadIdx.x == 0) cta_sum[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
seg_scan_kernel(const long long* __restrict__ cta_sum, int nb, long long* __restrict__ cta_off,
                int* __restrict__ dropped) {
  scan_serial(cta_sum, nb, cta_off);
  if (threadIdx.x == 0) dropped[0] = 0;
}

__global__ void __launch_bounds__(kThreads)
seg_write_kernel(const int* __restrict__ skey, const int* __restrict__ start,
                 const int* __restrict__ meta, int tile, long long group, long long s_cap,
                 const long long* __restrict__ cta_off, long long* __restrict__ base,
                 int* __restrict__ dropped) {
  const int g_count = meta[0];
  int lo, hi;
  seg_share(g_count, &lo, &hi);
  long long carry = cta_off[blockIdx.x];
  for (int r = lo; r < hi; r += blockDim.x) {            // the same rounds in every thread
    const int g = r + threadIdx.x;
    const bool head = g < hi && oct_head(skey, start, g);
    long long v = 0;
    int nseg = 0;
    if (head) v = round_up(oct_span(skey, start, g_count, g, tile, &nseg), group);
    long long total;
    const long long ex = block_exclusive(v, &total);
    if (head) {
      long long b = carry + ex;
      for (int k = g; k < g + nseg; ++k) {
        const long long len = start[k + 1] - start[k];
        base[k] = b;
        const long long fit = min(max(s_cap - b, 0LL), len);
        if (fit < len) atomicAdd(dropped, (int)(len - fit));
        b += round_up(len, tile);
      }
    }
    carry += total;
  }
}

__global__ void __launch_bounds__(kThreads)
tile_windows_kernel(const int* __restrict__ skey, const int* __restrict__ start,
                    const int* __restrict__ meta, const long long* __restrict__ base,
                    int num_tiles, int tile, int off, int n3, int* __restrict__ dstart,
                    int* __restrict__ dlen, int* __restrict__ tile_keys) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= num_tiles) return;
  const int g_count = meta[0];
  if (g_count == 0) {
    dstart[t] = 0;
    dlen[t] = 0;
    tile_keys[t] = n3;
    return;
  }
  // the last segment whose base is at most the tile's first slot (base[0] = 0)
  const long long target = (long long)t * tile;
  int lo = 0, hi = g_count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (base[mid] <= target) lo = mid; else hi = mid - 1;
  }
  const int st = start[lo];
  const long long len = start[lo + 1] - st;
  const long long into = target - base[lo];
  if (into < len) {
    dstart[t] = st + (int)into;
    dlen[t] = (int)min(len - into, (long long)tile);
    int k = skey[st];
    if (off > 0 && k >= off) k -= off;
    tile_keys[t] = k;
  } else {                                                // level-2 padding or the tail
    dstart[t] = start[lo + 1];
    dlen[t] = 0;
    tile_keys[t] = n3;
  }
}

// ---------------------------------------------------------------- place

struct Channels {
  const float* in[kMaxChannels];
  float* out[kMaxChannels];
};

__global__ void __launch_bounds__(kThreads)
place_kernel(const int* __restrict__ perm, const int* __restrict__ dstart,
             const int* __restrict__ dlen, int s_cap, int tile_bits, int n_chan,
             Channels ch, const int* __restrict__ pid_in, int* __restrict__ pid_out,
             unsigned char* __restrict__ active) {
  const long long d = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (d >= s_cap) return;
  const int t = (int)(d >> tile_bits);
  const int j = (int)(d - ((long long)t << tile_bits));
  const bool live = j < dlen[t];
  float v[kMaxChannels];
  int pid = s_cap;
  if (live) {
    const int src = perm[dstart[t] + j];
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) v[c] = c < n_chan ? __ldg(ch.in[c] + src) : 0.f;
    pid = __ldg(pid_in + src);
  } else {
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) v[c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c)
    if (c < n_chan) ch.out[c][d] = v[c];
  pid_out[d] = pid;
  active[d] = live ? 1 : 0;
}

}  // namespace rebucket

using namespace rebucket;

// The home-block keys of pos f32[3, n] and active u8[n]: key i32[n]
// (g^3 for an inactive slot or one outside the g^3 blocks).
extern "C" int cm_rebucket_keys(const float* pos, const unsigned char* active, int n,
                                float dx_inv, int block_bits, int g, int* key, void* stream) {
  if (n <= 0 || g <= 0 || block_bits < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)n + kThreads - 1) / kThreads;
  keys_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(pos, active, n, dx_inv,
                                                                       block_bits, g, key);
  return (int)cudaGetLastError();
}

// The stable sort of the keys src i32[n], each in [0, sentinel]: skey and
// perm i32[n] equal torch.sort(src, stable=True) bit for bit, perm as int32.
// bits: bit_length(sentinel - 1); the passes cover digit_bits (<= 10) each,
// the last the rest (one pass of width 0 where bits is 0).  Scratch: tmp
// i32[min(passes - 1, 2)][2][n] (null for one pass), counts i32[(2^digit_bits
// + 1) * ceil(n / 18432)], totals i32[2^digit_bits + 1]; active i32[1] gets
// the active count, which is also added to pairs i64[1].
extern "C" int cm_rebucket_sort(const int* src, int n, int sentinel, int bits, int digit_bits,
                                int* skey, int* perm, int* tmp, int* counts, int* totals,
                                int* active, long long* pairs, void* stream) {
  if (n <= 0 || sentinel <= 0 || bits < 0 || bits > 30 || digit_bits < 0 ||
      digit_bits > kMaxDigitBits || (bits > 0) != (digit_bits > 0) || pairs == nullptr)
    return (int)cudaErrorInvalidValue;
  const int passes = bits == 0 ? 1 : (bits + digit_bits - 1) / digit_bits;
  if (passes > 1 && tmp == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = (int)(((long long)n + kSortChunk - 1) / kSortChunk);
  auto buffer = [&](int k, int part) { return tmp + (long long)(2 * k + part) * n; };
  for (int q = 0; q < passes; ++q) {
    const bool first = q == 0, last = q == passes - 1;
    SortPass p;
    p.key_in = first ? src : buffer((q - 1) % 2, 0);
    p.val_in = first ? nullptr : buffer((q - 1) % 2, 1);
    p.key_out = last ? skey : buffer(q % 2, 0);
    p.val_out = last ? perm : buffer(q % 2, 1);
    p.skey = skey;
    p.perm = perm;
    p.count = first ? nullptr : active;
    p.n = n;
    p.shift = q * digit_bits;
    p.width = bits - p.shift < digit_bits ? bits - p.shift : digit_bits;
    p.sentinel = sentinel;
    const int buckets = (1 << p.width) + (first ? 1 : 0);
    if (first) {
      sort_count_kernel<true><<<nb, kThreads, 0, st>>>(p, nb, counts);
    } else {
      sort_count_kernel<false><<<nb, kThreads, 0, st>>>(p, nb, counts);
    }
    sort_scan_kernel<<<buckets, kThreads, 0, st>>>(p.count, n, nb, counts, totals);
    if (first) {
      sort_scatter_kernel<true><<<nb, kThreads, 0, st>>>(p, nb, counts, totals, active, pairs);
    } else {
      sort_scatter_kernel<false><<<nb, kThreads, 0, st>>>(p, nb, counts, totals, active, pairs);
    }
  }
  return (int)cudaGetLastError();
}

// The segment heads of the sorted keys skey i32[n]: seg_start i32[G + 1]
// (room for min(n, keys) + 1), meta i32[2] = (G, active count); cta_count and
// cta_off i32[ceil(n / 2048)] are scratch.
extern "C" int cm_rebucket_heads(const int* skey, int n, int sentinel, int* seg_start,
                                 int* cta_count, int* cta_off, int* meta, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = (n + kChunk - 1) / kChunk;
  heads_count_kernel<<<nb, kThreads, 0, st>>>(skey, n, sentinel, cta_count);
  heads_scan_kernel<<<1, kScanThreads, 0, st>>>(cta_count, nb, cta_off, meta, seg_start);
  heads_write_kernel<<<nb, kThreads, 0, st>>>(skey, n, sentinel, cta_off, meta, seg_start);
  return (int)cudaGetLastError();
}

// The tile plan from the heads: base i64[G] (room for the heads' G),
// dstart, dlen, tile_keys i32[num_tiles], dropped i32[1]; cta_sum and
// cta_off i64[512] are scratch.  off: the region offset (0 without one).
extern "C" int cm_rebucket_plan(const int* skey, const int* seg_start, const int* meta,
                                int tile, int group_tiles, int num_tiles, int off, int n3,
                                long long* cta_sum, long long* cta_off, long long* base,
                                int* dstart, int* dlen, int* tile_keys, int* dropped,
                                void* stream) {
  if (tile <= 0 || group_tiles <= 0 || num_tiles <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long group = (long long)group_tiles * tile;
  const long long s_cap = (long long)num_tiles * tile;
  seg_count_kernel<<<kSegCtas, kThreads, 0, st>>>(skey, seg_start, meta, tile, group, cta_sum);
  seg_scan_kernel<<<1, kScanThreads, 0, st>>>(cta_sum, kSegCtas, cta_off, dropped);
  seg_write_kernel<<<kSegCtas, kThreads, 0, st>>>(skey, seg_start, meta, tile, group, s_cap,
                                                  cta_off, base, dropped);
  tile_windows_kernel<<<(num_tiles + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      skey, seg_start, meta, base, num_tiles, tile, off, n3, dstart, dlen, tile_keys);
  return (int)cudaGetLastError();
}

// Every channel into the planned layout: in/out hold n_chan (<= 16) pointers
// to f32[s_cap] rows; pid i32[s_cap]; active u8[s_cap]; tile a power of two.
extern "C" int cm_rebucket_place(const int* perm, const int* dstart, const int* dlen,
                                 int s_cap, int tile, int n_chan, const void* const* in,
                                 void* const* out, const int* pid_in, int* pid_out,
                                 unsigned char* active, void* stream) {
  if (s_cap <= 0 || tile <= 0 || (tile & (tile - 1)) != 0 || n_chan < 0 ||
      n_chan > kMaxChannels)
    return (int)cudaErrorInvalidValue;
  Channels ch;
  for (int c = 0; c < kMaxChannels; ++c) {
    ch.in[c] = c < n_chan ? static_cast<const float*>(in[c]) : nullptr;
    ch.out[c] = c < n_chan ? static_cast<float*>(out[c]) : nullptr;
  }
  int tile_bits = 0;
  while ((1 << tile_bits) < tile) ++tile_bits;
  const long long blocks = ((long long)s_cap + kThreads - 1) / kThreads;
  place_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      perm, dstart, dlen, s_cap, tile_bits, n_chan, ch, pid_in, pid_out, active);
  return (int)cudaGetLastError();
}
