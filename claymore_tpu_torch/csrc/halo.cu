// The mesh's halo exchange and migration pack on the card: the packs of
// parallel/halo.py (pack_windows, mass_mask, add_rows, migrate_pack), the
// plain twins each entry point here is held against, bit for bit: they
// compare integers, move data, multiply by 1.0 or 0.0 and add once.
//
// Replaces no Pallas kernel: the JAX package runs these in XLA inside
// shard_map (claymore_tpu/parallel/multi.py:220 _pack_window, :250
// exchange_halo, :307 halo_mass_mask, :325 add_halo, :339 migrate's pack
// at :378-400).  The reference packs and unpacks its halo blocks with CUDA
// kernels too (collect_halo_grid_blocks, reduce_halo_grid_blocks).
//
// Bound: device memory (utils/bounds.py:halo_bound, migrate_bound).
// * cm_halo_count + cm_halo_write (the halo pack of one shard over every
//   direction): each pool-row key read once (4 B), each packed row read
//   (8 KB) and every row of each pack written (8 KB + 8 B of meta).  The
//   plain chain runs ~60 ops a direction (a window test per axis, a
//   compaction, a gather, a mask multiply, the bits).
// * cm_halo_mask: the received keys and bits read, G^3 + 1 bytes written.
// * cm_halo_add: the received rows read, the pool rows they hit read and
//   written.
// * cm_migrate_pack: pos[dim] and active read per slot (5 B), active
//   written (1 B), C x k words written per side.
//
// Design.
// * One compaction plan serves the halo pack and the migration pack: a
//   flag functor gives each element a word of up to 8 flag bits (the
//   directions of a pool row; the left and right crossing of a slot).  A
//   count pass over CTA chunks counts each flag (warp ballots, a shared
//   word per warp), one CTA scans each flag's chunk counts and writes its
//   total and the capacity overflow summed over the flags, and a write
//   pass in the CTAs whose chunk holds a wanted flag below the capacity
//   reads its chunk again and writes each flagged element's index at its
//   rank (ballot, the warps' prefix, the lanes below), leaving once every
//   flag's prefix reaches the capacity.  Crossers are rare, so most chunks
//   of a migration pack are read once.
// * The halo pack's flags are the window tests of every direction the
//   shard ships (at most 8, one argument struct): oct_coord of the key,
//   then chi > edge - m && clo < edge + m on each axis it crosses.  Count
//   and scan run on the caller's (main) stream, where the overflow is read;
//   the write pass and the rows run on the side stream.  The rows: one CTA
//   of 128 threads a (direction, rank) in [0, h): rank < count takes its
//   index's pool row, a rank past it pool row nb - 1 with key no, as the
//   twin's clamp gives it.  The row is multiplied (not selected) by its
//   lane mask, so x * 0.0f keeps -0.0 and NaN as the twin's multiply does;
//   the 8 mass bits read channels 0-3 of the masked row (!= 0.0f), OR-ed
//   over the CTA.
// * The mass mask: a memset of bool[G^3 + 1] and one launch over every
//   received direction's (key, bits): idempotent stores, in any order.
// * The add: one launch a received direction, in the twin's order (two
//   directions may carry one oct).  A direction's keys are distinct octs
//   (or all 0 with zero rows, where a dense group ships zeros: every
//   racing writer then stores the same x + 0.0f), so each destination row
//   takes one plain add, bit-equal to index_add_.  Keys past the oct keys
//   and octs the table maps to the null row are skipped; the null row is
//   zeroed first, which leaves the twin's final pool[null] = 0.
// * The migration pack: the home block along dim as csrc/rebucket.cu
//   computes it (__fmul_rn / __fadd_rn: no FMA contraction that torch's
//   floor(pos * dx_inv + 0.5) would not make); the count pass also writes
//   the new active (every crosser cleared, shipped or not); the payload
//   pass, one thread a column of each side, copies 32-bit words (pid's
//   bits too), slot S - 1 with valid 0.0f past the last crosser.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace halo {

using cm_scan::scan_serial;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kMaxDirs = 8;
constexpr int kMaxAxes = 2;
constexpr int kRowThreads = 128;
constexpr int kRow4 = 16 * 128 / 4;               // a pool row as float4
constexpr int kRowPer = kRow4 / kRowThreads;      // float4 a thread of a row
constexpr int kHaloRounds = 1;                    // pool rows a thread of a chunk
constexpr int kMigRounds = 16;                    // slots a thread of a chunk
constexpr int kMaxChannels = 32;

// the windows of one shard's directions
struct Windows {
  int n;
  int naxes[kMaxDirs];
  int dim[kMaxDirs][kMaxAxes];
  int edge[kMaxDirs][kMaxAxes];
};

// ---------------------------------------------------------------- flags

// the window bits of pool row i: live (below count and nb, an oct key) and
// inside window d on every axis d crosses
struct HaloFlags {
  const int* keys;
  const int* count;                               // i32[1] on the card
  int nb, no, g, gzo, m;
  Windows w;

  __device__ __forceinline__ unsigned operator()(long long i) const {
    if (i >= nb || i >= count[0]) return 0u;
    const int k = keys[i];
    if ((unsigned)k >= (unsigned)no) return 0u;
    const int bzo = k % gzo, by = (k / gzo) % g, bx = min(k / (gzo * g), g - 1);
    unsigned bits = 0u;
#pragma unroll
    for (int d = 0; d < kMaxDirs; ++d) {
      if (d >= w.n) break;
      bool in = true;
      for (int a = 0; a < w.naxes[d]; ++a) {
        const int dim = w.dim[d][a], e = w.edge[d][a];
        const int lo = dim == 0 ? bx : dim == 1 ? by : bzo * 8;
        const int hi = dim == 2 ? lo + 8 : lo + 1;
        in = in && hi > e - m && lo < e + m;
      }
      bits |= (in ? 1u : 0u) << d;
    }
    return bits;
  }
  __device__ __forceinline__ void counted(long long, unsigned) const {}
};

// a slot's crossing: bit 0 its home block along dim below lo, bit 1 at or
// past hi; active slots only.  counted() writes the new active flag.
struct MigrateFlags {
  const float* pos;                               // pos[dim], S floats
  const uint8_t* active;
  uint8_t* new_active;
  float dx_inv;
  int block_bits, lo, hi;

  __device__ __forceinline__ unsigned operator()(long long i) const {
    if (!active[i]) return 0u;
    const float x = __fadd_rn(__fmul_rn(pos[i], dx_inv), 0.5f);
    const int cell = (int)floorf(x);
    const int hb = (int)((unsigned)cell - 2u) >> block_bits;
    return (hb < lo ? 1u : 0u) | (hb >= hi ? 2u : 0u);
  }
  __device__ __forceinline__ void counted(long long i, unsigned bits) const {
    new_active[i] = active[i] && bits == 0u ? 1 : 0;
  }
};

// ---------------------------------------------------------------- compaction

// per flag d, the flagged elements of each chunk of kRounds * kThreads:
// cta_count[d * nchunks + chunk]
template <class F, int kRounds>
__global__ void __launch_bounds__(kThreads)
count_kernel(F f, long long n, int nflags, int nchunks, int* __restrict__ cta_count) {
  __shared__ int wsum[kMaxDirs][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * kRounds * kThreads + threadIdx.x;
  int c[kMaxDirs];
#pragma unroll
  for (int d = 0; d < kMaxDirs; ++d) c[d] = 0;
#pragma unroll 4
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + (long long)r * kThreads;
    if (i < n) {
      const unsigned bits = f(i);
      f.counted(i, bits);
#pragma unroll
      for (int d = 0; d < kMaxDirs; ++d) c[d] += (bits >> d) & 1u;
    }
  }
#pragma unroll
  for (int d = 0; d < kMaxDirs; ++d) {
    const int s = __reduce_add_sync(0xffffffffu, c[d]);
    if (lane == 0) wsum[d][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < nflags) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += wsum[threadIdx.x][w];
    cta_count[threadIdx.x * nchunks + blockIdx.x] = s;
  }
}

// each flag's chunk prefixes (cta_off) and total; overflow[0] = the sum
// over the flags of max(total - cap, 0)
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ cta_count, int nflags, int nchunks, int cap,
            int* __restrict__ cta_off, int* __restrict__ total, int* __restrict__ overflow) {
  int over = 0;
  for (int d = 0; d < nflags; ++d) {
    const int t = scan_serial(cta_count + (long long)d * nchunks, nchunks,
                              cta_off + (long long)d * nchunks);
    if (threadIdx.x == 0) total[d] = t;
    over += max(t - cap, 0);
  }
  if (threadIdx.x == 0) overflow[0] = over;
}

// idx[d * cap + rank] = the index of the rank-th element with flag d, for
// rank < cap and every flag in `want`; a chunk without such an element
// leaves at once
template <class F, int kRounds>
__global__ void __launch_bounds__(kThreads)
write_kernel(F f, long long n, int nflags, unsigned want, int nchunks,
             const int* __restrict__ cta_count, const int* __restrict__ cta_off, int cap,
             int* __restrict__ idx) {
  __shared__ int wsum[kMaxDirs][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int carry[kMaxDirs];
  bool open = false;
#pragma unroll
  for (int d = 0; d < kMaxDirs; ++d) {
    const int at = d * nchunks + blockIdx.x;
    const bool mine = d < nflags && ((want >> d) & 1u) && cta_count[at] > 0;
    carry[d] = mine ? cta_off[at] : cap;
    open = open || carry[d] < cap;
  }
  if (!open) return;                                      // the same in every thread
  const long long base = (long long)blockIdx.x * kRounds * kThreads + threadIdx.x;
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + (long long)r * kThreads;
    const unsigned bits = i < n ? f(i) : 0u;
    unsigned bal[kMaxDirs];
#pragma unroll
    for (int d = 0; d < kMaxDirs; ++d) {
      bal[d] = __ballot_sync(0xffffffffu, (bits >> d) & 1u);
      if (lane == 0) wsum[d][warp] = __popc(bal[d]);
    }
    __syncthreads();
    bool more = false;
#pragma unroll
    for (int d = 0; d < kMaxDirs; ++d) {
      int before = 0, all = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int s = wsum[d][w];
        before += w < warp ? s : 0;
        all += s;
      }
      if (((bits >> d) & 1u) && carry[d] < cap) {
        const int rank = carry[d] + before + __popc(bal[d] & below);
        if (rank < cap) idx[(long long)d * cap + rank] = (int)i;
      }
      carry[d] += all;
      more = more || carry[d] < cap;
    }
    if (!more) break;                                     // the same in every thread
    __syncthreads();                                      // wsum is reused
  }
}

template <int kRounds>
constexpr long long chunks(long long n) {
  return (n + (long long)kRounds * kThreads - 1) / ((long long)kRounds * kThreads);
}

template <class F, int kRounds>
cudaError_t plan_count(const F& f, long long n, int nflags, int cap, int* cta_count,
                       int* cta_off, int* total, int* overflow, cudaStream_t st) {
  const int nchunks = (int)chunks<kRounds>(n);
  count_kernel<F, kRounds><<<nchunks, kThreads, 0, st>>>(f, n, nflags, nchunks, cta_count);
  scan_kernel<<<1, kScanThreads, 0, st>>>(cta_count, nflags, nchunks, cap, cta_off, total,
                                          overflow);
  return cudaGetLastError();
}

template <class F, int kRounds>
void plan_write(const F& f, long long n, int nflags, unsigned want, int cap,
                const int* cta_count, const int* cta_off, int* idx, cudaStream_t st) {
  const int nchunks = (int)chunks<kRounds>(n);
  write_kernel<F, kRounds><<<nchunks, kThreads, 0, st>>>(f, n, nflags, want, nchunks,
                                                         cta_count, cta_off, cap, idx);
}

// ---------------------------------------------------------------- halo rows

// the packed directions and their outputs: meta i32[2, h], rows f32[h, 16,
// 128] each
struct Packs {
  int dir[kMaxDirs];
  int* meta[kMaxDirs];
  float4* rows[kMaxDirs];
};

// one CTA a (rank r, packed direction p): meta[p] = (key, bits) at r, rows[p]
// row r = the pool row of the r-th oct of the window (nb - 1 past the
// count) times its lane mask
__global__ void __launch_bounds__(kRowThreads)
halo_rows_kernel(const float4* __restrict__ pool, const int* __restrict__ keys,
                 const int* __restrict__ idx, const int* __restrict__ total, Windows w, int h,
                 int nb, int no, int gzo, int m, Packs out) {
  __shared__ unsigned wbits[kRowThreads / 32];
  const int r = blockIdx.x, p = blockIdx.y;
  const int d = out.dir[p];
  const bool valid = r < min(total[d], h);
  const int slot = valid ? idx[(long long)d * h + r] : nb - 1;
  const int key = valid ? keys[slot] : no;
  const int t = threadIdx.x;
  const int blk = (t & 31) >> 2;                  // the block of this thread's 4 lanes
  bool in = valid;
  if (valid) {
    const int bz = (key % gzo) * 8 + blk;
    for (int a = 0; a < w.naxes[d]; ++a)
      if (w.dim[d][a] == 2) in = in && bz >= w.edge[d][a] - m && bz < w.edge[d][a] + m;
  }
  const float f = in ? 1.0f : 0.0f;
  const float4* src = pool + (long long)slot * kRow4;
  float4 v[kRowPer];
#pragma unroll
  for (int q = 0; q < kRowPer; ++q) v[q] = __ldg(src + t + q * kRowThreads);
  float4* dst = out.rows[p] + (long long)r * kRow4;
#pragma unroll
  for (int q = 0; q < kRowPer; ++q) {
    v[q].x = __fmul_rn(v[q].x, f);
    v[q].y = __fmul_rn(v[q].y, f);
    v[q].z = __fmul_rn(v[q].z, f);
    v[q].w = __fmul_rn(v[q].w, f);
    dst[t + q * kRowThreads] = v[q];
  }
  // q = 0 holds channels 0-3 (the mass rows): float4 t is channel t / 32,
  // lanes 4 (t % 32) .. + 3, all in block blk
  const bool nz = v[0].x != 0.0f || v[0].y != 0.0f || v[0].z != 0.0f || v[0].w != 0.0f;
  const unsigned b = __reduce_or_sync(0xffffffffu, nz ? 1u << blk : 0u);
  if ((t & 31) == 0) wbits[t >> 5] = b;
  __syncthreads();
  if (t == 0) {
    unsigned all = 0u;
#pragma unroll
    for (int k = 0; k < kRowThreads / 32; ++k) all |= wbits[k];
    out.meta[p][r] = key;
    out.meta[p][h + r] = (int)all;
  }
}

// ---------------------------------------------------------------- mask, add

struct Received {
  const int* keys[kMaxDirs];
  const int* bits[kMaxDirs];
};

__global__ void __launch_bounds__(kThreads)
halo_mask_kernel(Received rv, int h, int no, int g, int gzo, uint8_t* __restrict__ mask) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int d = blockIdx.y;
  if (r >= h) return;
  const int key = rv.keys[d][r];
  const int bits = rv.bits[d][r];
  if ((unsigned)key >= (unsigned)no || (bits & 0xff) == 0) return;
  const int bzo = key % gzo, by = (key / gzo) % g, bx = min(key / (gzo * g), g - 1);
  const long long base = ((long long)bx * g + by) * g + bzo * 8;
#pragma unroll
  for (int b = 0; b < 8; ++b)
    if ((bits >> b) & 1) mask[base + b] = 1;
}

__global__ void __launch_bounds__(kRowThreads)
halo_add_kernel(const int* __restrict__ keys, const float4* __restrict__ rows,
                const int* __restrict__ table, int no, int null_oct, float4* __restrict__ pool) {
  const int r = blockIdx.x;
  const int key = keys[r];
  if ((unsigned)key >= (unsigned)no) return;              // the same in the whole CTA
  const int slot = table[key];
  if (slot == null_oct) return;
  const float4* src = rows + (long long)r * kRow4;
  float4* dst = pool + (long long)slot * kRow4;
  float4 a[kRowPer], b[kRowPer];
#pragma unroll
  for (int q = 0; q < kRowPer; ++q) {
    a[q] = dst[threadIdx.x + q * kRowThreads];
    b[q] = __ldg(src + threadIdx.x + q * kRowThreads);
  }
#pragma unroll
  for (int q = 0; q < kRowPer; ++q)
    dst[threadIdx.x + q * kRowThreads] =
        make_float4(__fadd_rn(a[q].x, b[q].x), __fadd_rn(a[q].y, b[q].y),
                    __fadd_rn(a[q].z, b[q].z), __fadd_rn(a[q].w, b[q].w));
}

// ---------------------------------------------------------------- migration payload

struct Channels {
  const uint32_t* src[kMaxChannels];              // rows 3 (valid) and 4 (pid) aside
  int n;
};

// column c of side s (blockIdx.y): slot idx[s][c] below the side's count,
// else slot S - 1 with valid 0.0f; row 3 valid, row 4 pid's bits
__global__ void __launch_bounds__(kThreads)
payload_kernel(Channels ch, const uint32_t* __restrict__ pid, const int* __restrict__ idx,
               const int* __restrict__ total, int k, long long s_cap,
               uint32_t* __restrict__ left, uint32_t* __restrict__ right) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int s = blockIdx.y;
  if (c >= k) return;
  const bool valid = c < min(total[s], k);
  const long long slot = valid ? idx[(long long)s * k + c] : s_cap - 1;
  uint32_t* out = s ? right : left;
  for (int row = 0; row < ch.n; ++row) {
    uint32_t v;
    if (row == 3) v = __float_as_uint(valid ? 1.0f : 0.0f);
    else if (row == 4) v = pid[slot];
    else v = ch.src[row][slot];
    out[(long long)row * k + c] = v;
  }
}

Windows read_windows(const int* spec, int n) {
  Windows w{};
  w.n = n;
  for (int d = 0; d < n; ++d) {
    w.naxes[d] = spec[d * 5];
    for (int a = 0; a < kMaxAxes; ++a) {
      w.dim[d][a] = spec[d * 5 + 1 + 2 * a];
      w.edge[d][a] = spec[d * 5 + 2 + 2 * a];
    }
  }
  return w;
}

bool windows_ok(const int* spec, int n) {
  if (n <= 0 || n > kMaxDirs) return false;
  for (int d = 0; d < n; ++d)
    if (spec[d * 5] < 0 || spec[d * 5] > kMaxAxes) return false;
  return true;
}

}  // namespace halo

using namespace halo;

// The halo pack's count and scan over one shard's pool-row keys i32[nb]
// below count i32[1] (both on the card): spec i32[n, 5] on the host, per
// direction (axes, dim0, edge0, dim1, edge1); cta_count and cta_off
// i32[n, ceil(nb / 256)], total i32[n] (each window's octs) and overflow
// i32[1] (the octs past h over every direction) are written.
extern "C" int cm_halo_count(const int* keys, const int* count, int nb, int no, int g, int m,
                             const int* spec, int n, int h, int* cta_count, int* cta_off,
                             int* total, int* overflow, void* stream) {
  if (nb <= 0 || no <= 0 || g < 8 || h <= 0 || !windows_ok(spec, n))
    return (int)cudaErrorInvalidValue;
  const HaloFlags f{keys, count, nb, no, g, g >> 3, m, read_windows(spec, n)};
  return (int)plan_count<HaloFlags, kHaloRounds>(f, nb, n, h, cta_count, cta_off, total,
                                                 overflow, (cudaStream_t)stream);
}

// The halo pack's write pass and rows for the npack packed directions
// pack_dir i32[npack] (host) of the cm_halo_count plan (spec, cta_count,
// cta_off, total): idx i32[n, h] scratch; for each packed direction meta
// i32[2, h] (keys, mass bits) and rows f32[h, 16, 128] (npack pointers each,
// on the host) from pool f32[nb + 1, 16, 128].
extern "C" int cm_halo_write(const float* pool, const int* keys, const int* count, int nb, int no,
                             int g, int m, const int* spec, int n, const int* pack_dir, int npack,
                             int h, const int* cta_count, const int* cta_off, const int* total,
                             int* idx, const void* const* meta, const void* const* rows,
                             void* stream) {
  if (nb <= 0 || no <= 0 || g < 8 || h <= 0 || !windows_ok(spec, n) || npack <= 0 ||
      npack > n)
    return (int)cudaErrorInvalidValue;
  const Windows w = read_windows(spec, n);
  unsigned want = 0u;
  Packs out{};
  for (int p = 0; p < npack; ++p) {
    if (pack_dir[p] < 0 || pack_dir[p] >= n) return (int)cudaErrorInvalidValue;
    want |= 1u << pack_dir[p];
    out.dir[p] = pack_dir[p];
    out.meta[p] = static_cast<int*>(const_cast<void*>(meta[p]));
    out.rows[p] = static_cast<float4*>(const_cast<void*>(rows[p]));
  }
  cudaStream_t st = (cudaStream_t)stream;
  const HaloFlags f{keys, count, nb, no, g, g >> 3, m, w};
  plan_write<HaloFlags, kHaloRounds>(f, nb, n, want, h, cta_count, cta_off, idx, st);
  halo_rows_kernel<<<dim3(h, npack), kRowThreads, 0, st>>>(
      reinterpret_cast<const float4*>(pool), keys, idx, total, w, h, nb, no, g >> 3, m, out);
  return (int)cudaGetLastError();
}

// The halo mass mask u8[G^3 + 1] of n received directions (keys and bits
// i32[h] each, pointers on the host): zeroed, then 1 at every block whose
// bit is set.
extern "C" int cm_halo_mask(int n, const void* const* keys, const void* const* bits, int h,
                            int no, int g, unsigned char* mask, void* stream) {
  if (n <= 0 || n > kMaxDirs || h <= 0 || g < 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n3 = (long long)g * g * g;
  cudaError_t err = cudaMemsetAsync(mask, 0, n3 + 1, st);
  if (err != cudaSuccess) return (int)err;
  Received rv{};
  for (int d = 0; d < n; ++d) {
    rv.keys[d] = static_cast<const int*>(keys[d]);
    rv.bits[d] = static_cast<const int*>(bits[d]);
  }
  halo_mask_kernel<<<dim3((h + kThreads - 1) / kThreads, n), kThreads, 0, st>>>(
      rv, h, no, g, g >> 3, mask);
  return (int)cudaGetLastError();
}

// Add n received directions (keys i32[h], rows f32[h, 16, 128], pointers on
// the host) into pool f32[nb + 1, 16, 128] in place, in order, through
// table i32[no + 1]; the null row is zeroed first.
extern "C" int cm_halo_add(int n, const void* const* keys, const void* const* rows, int h,
                           const int* table, int no, int null_oct, float* pool, void* stream) {
  if (n <= 0 || n > kMaxDirs || h <= 0 || no <= 0 || null_oct < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(pool + (long long)null_oct * 16 * 128, 0,
                                    16 * 128 * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  for (int d = 0; d < n; ++d) {
    halo_add_kernel<<<h, kRowThreads, 0, st>>>(
        static_cast<const int*>(keys[d]), static_cast<const float4*>(rows[d]), table, no,
        null_oct, reinterpret_cast<float4*>(pool));
  }
  return (int)cudaGetLastError();
}

// One shard's migration pack along one axis: pos_dim f32[S] (pos[dim]),
// active u8[S]; new_active u8[S] written; n_ch payload rows, their sources
// src (n_ch pointers on the host, 32-bit words of S; entries 3 and 4 are
// not read: valid and pid); idx i32[2, k], cta_count and cta_off
// i32[2, ceil(S / 4096)], total i32[2] scratch; left and right f32[n_ch, k];
// dropped i32[1] = the crossers past k on both sides.
extern "C" int cm_migrate_pack(const float* pos_dim, const unsigned char* active, int s_cap,
                               float dx_inv, int block_bits, int lo, int hi, int k, int n_ch,
                               const void* const* src, const int* pid, unsigned char* new_active,
                               int* idx, int* cta_count, int* cta_off, int* total, float* left,
                               float* right, int* dropped, void* stream) {
  if (s_cap <= 0 || k <= 0 || n_ch < 5 || n_ch > kMaxChannels)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  MigrateFlags f{pos_dim, active, new_active, dx_inv, block_bits, lo, hi};
  cudaError_t err = plan_count<MigrateFlags, kMigRounds>(f, s_cap, 2, k, cta_count, cta_off,
                                                         total, dropped, st);
  if (err != cudaSuccess) return (int)err;
  plan_write<MigrateFlags, kMigRounds>(f, s_cap, 2, 3u, k, cta_count, cta_off, idx, st);
  Channels ch{};
  ch.n = n_ch;
  for (int c = 0; c < n_ch; ++c) ch.src[c] = static_cast<const uint32_t*>(src[c]);
  payload_kernel<<<dim3((k + kThreads - 1) / kThreads, 2), kThreads, 0, st>>>(
      ch, reinterpret_cast<const uint32_t*>(pid), idx, total, k, s_cap,
      reinterpret_cast<uint32_t*>(left), reinterpret_cast<uint32_t*>(right));
  return (int)cudaGetLastError();
}

// What the card gives sub-kernel `which` (0 count, 1 scan, 2 write, 3 rows:
// the halo pack's; 4 mask; 5 add; 6 count, 7 write, 8 payload: the
// migration pack's): out i32[2] = registers per thread, resident blocks
// per SM.
extern "C" int cm_halo_info(int which, int* out) {
  const void* fns[] = {
      (const void*)count_kernel<HaloFlags, kHaloRounds>, (const void*)scan_kernel,
      (const void*)write_kernel<HaloFlags, kHaloRounds>, (const void*)halo_rows_kernel,
      (const void*)halo_mask_kernel, (const void*)halo_add_kernel,
      (const void*)count_kernel<MigrateFlags, kMigRounds>,
      (const void*)write_kernel<MigrateFlags, kMigRounds>, (const void*)payload_kernel};
  const int threads[] = {kThreads, kScanThreads, kThreads, kRowThreads, kThreads, kRowThreads,
                         kThreads, kThreads, kThreads};
  if (which < 0 || which >= (int)(sizeof(fns) / sizeof(fns[0])))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], fns[which], threads[which],
                                                            0);
}
