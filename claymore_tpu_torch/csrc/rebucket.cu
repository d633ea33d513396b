// The full rebucket on the card: everything of core/partition.py:
// sort_permute but the stable key sort, which stays torch's.
//
// Replaces no Pallas kernel: the JAX package runs this stage in XLA
// (claymore_tpu/core/partition.py:83 sort_permute, one lax.sort carrying
// every channel at :147, then a searchsorted over the monotone destination
// slots and one window slice per tile).  The port's plain version
// (core/partition.py: home_keys, segment_heads, segment_bases,
// tile_windows, place) is what each kernel here is held against, bit for
// bit: the stage only moves data and does integer arithmetic.
//
// Bound: device memory.  Beyond the sort, an active slot's position (12
// bytes) for its key, its sorted key (4), its sort index (8) and every
// 4-byte channel (position 3, the material's fields, the id) read once;
// every slot's active flag read (1), its key written (4), every channel
// written and its new flag written: 30 + 8 C bytes a slot for C channels
// when all are active, 134 for FixedCorotated
// (utils/bounds.py:rebucket_bound).  Everything else scales with the block
// segments (at most one per occupied block), not the slots.
//
// Design.  The destination slot of sorted element i in block segment g is
// base[g] + (i - seg_start[g]): monotone in i, so each destination tile is
// one contiguous window of sorted indices.  Four stages, each a plain C
// entry point (the stable sort between the first two is torch's):
// * cm_rebucket_keys, one thread a slot: its home-block key from its
//   position (12 bytes in, 4 out), the sentinel for an inactive slot;
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
place_kernel(const long long* __restrict__ perm, const int* __restrict__ dstart,
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
    const long long src = perm[dstart[t] + j];
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
extern "C" int cm_rebucket_place(const long long* perm, const int* dstart, const int* dlen,
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
