// The partition rebuild and the first-k compaction on the card:
// core/partition.py:rebuild (oct_flags, then remap), finalize_tiles and
// _first_marked.
//
// Replaces no Pallas kernel: the JAX package runs these in XLA
// (claymore_tpu/core/partition.py:401 rebuild, its jnp.nonzero(omask,
// size=nb, fill_value=no) at :448; :353 finalize_tiles; jnp.nonzero(...,
// size=, fill_value=) in parallel/multi.py:234,382,421 and
// core/partition.py:275,297).  The port's plain twins (core/partition.py:
// _first_marked, oct_flags, remap, finalize_tiles) are what each entry
// point here is held against, bit for bit: they move data, compare floats
// with zero and do integer arithmetic.
//
// Bound: device memory (utils/bounds.py:partition_bound).
// * cm_first_marked over a bool[N]: N flag bytes read, 8 bytes written per
//   output index.  The plain chain (an int64 cumsum, a where, an int64
//   arange and a scatter) moves ~45 bytes a flag.
// * cm_partition_oct_mask: per live pool row its mass rows (rows 0-3, 2 KB)
//   and its key, per tile its key, the halo mask (G^3 bytes) where given,
//   one flag byte written per oct key.  The plain chain builds and dilates
//   the G^3 block cube (7 or 63 shifted ORs of it).
// * cm_partition_remap: the flags read, the keys and the table written,
//   one copy of each live pool row read, the new pool written.
// * cm_partition_finalize_tiles: per tile its key and one table entry
//   read, its address, coordinates and flag written.
//
// Design.
// * The compaction (first_marked, and the oct keys of remap) is three
//   passes over CTA chunks of kChunk flags: each CTA counts its chunk with
//   16-byte loads (__vcmpne4 + __popc: 16 flags a load); one CTA scans the
//   chunk counts (and writes the total, and for remap count and overflow);
//   then only the CTAs whose prefix lies below `size` read their chunk
//   again and place their indices in ascending order (a block scan of the
//   threads' counts each round of kRoundBytes), leaving as soon as the
//   prefix reaches `size`.  A last pass writes `fill` into [min(total,
//   size), size).  No int64 temporary of a flag exists.  In remap every CTA
//   runs the write pass, since it writes each oct key's table entry (its
//   slot, or null_oct) from the same ranks: the table needs no fill and no
//   scatter.
// * oct_mask writes every flag once from the halo mask (8 block bytes to
//   one oct: one uint4 load holds two octs; 0 without a mask), then stores
//   1 into the flags of the live rows with mass (one warp a row, `!= 0.0f`
//   as octpool.block_has_mass: NaN counts, -0.0 does not) and of every
//   tile's block dilated by the transfer stencil ({0,1}^3 at span 2,
//   {-1..2}^3 at span 4, clipped at the grid's faces as _dilate clips), one
//   store per oct the stencil's z range meets; a tile with the key of the
//   tile before it is skipped.  The G^3 block cube is never built.
// * remap copies one 8 KB pool row per CTA (128 threads, four 16-byte loads
//   each issued before the stores): row i takes old row old_table[keys[i]]
//   where keys[i] < no (for a newly activated oct that is the old null row,
//   as in the twin and the JAX package), else zeros; the null row is zero.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace partition {

using cm_scan::block_exclusive;
using cm_scan::scan_serial;

constexpr int kThreads = 256;
constexpr int kVec = 16;                          // flags a thread loads at once
constexpr int kRounds = 4;
constexpr int kRoundBytes = kThreads * kVec;      // flags a CTA takes a round
constexpr int kChunk = kRoundBytes * kRounds;     // flags a CTA of the compaction
constexpr int kScanThreads = 1024;
constexpr int kRowFloats = 16 * 128;              // a pool row
constexpr int kMassFloat4 = 4 * 128 / 4;          // its mass rows 0-3 as float4
constexpr int kRowThreads = 128;
constexpr int kMaxModels = 16;

// ---------------------------------------------------------------- flags

// 16 flags from i (16-aligned) as four words, a byte 1 where a flag is set;
// the flags past n read as 0
__device__ __forceinline__ void load16(const uint8_t* __restrict__ mark, long long i,
                                       long long n, uint32_t w[4]) {
  if (i + kVec <= n) {
    const uint4 v = *reinterpret_cast<const uint4*>(mark + i);
    w[0] = __vcmpne4(v.x, 0u) & 0x01010101u;
    w[1] = __vcmpne4(v.y, 0u) & 0x01010101u;
    w[2] = __vcmpne4(v.z, 0u) & 0x01010101u;
    w[3] = __vcmpne4(v.w, 0u) & 0x01010101u;
    return;
  }
  w[0] = w[1] = w[2] = w[3] = 0u;
  for (int j = 0; i + j < n; ++j)
    if (mark[i + j]) w[j >> 2] |= 1u << (8 * (j & 3));
}

__device__ __forceinline__ int count16(const uint32_t w[4]) {
  return __popc(w[0]) + __popc(w[1]) + __popc(w[2]) + __popc(w[3]);
}

__device__ __forceinline__ bool flag_at(const uint32_t w[4], int j) {
  return (w[j >> 2] >> (8 * (j & 3))) & 1u;
}

// ---------------------------------------------------------------- compaction

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ mark, long long n, int* __restrict__ cta_count) {
  const long long base = (long long)blockIdx.x * kChunk + threadIdx.x * kVec;
  int c = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + (long long)r * kRoundBytes;
    if (i < n) {
      uint32_t w[4];
      load16(mark, i, n, w);
      c += count16(w);
    }
  }
  int total;
  block_exclusive(c, &total);
  if (threadIdx.x == 0) cta_count[blockIdx.x] = total;
}

// the chunks' prefixes; total[0] = the marked flags, and with count_out
// (remap) count = min(total, size), overflow = max(total - size, 0)
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ cta_count, int nb, int size, int* __restrict__ cta_off,
            int* __restrict__ total, int* __restrict__ count_out, int* __restrict__ overflow_out) {
  const int t = scan_serial(cta_count, nb, cta_off);
  if (threadIdx.x == 0) {
    total[0] = t;
    if (count_out != nullptr) {
      count_out[0] = min(t, size);
      overflow_out[0] = max(t - size, 0);
    }
  }
}

// out[k] = the index of the k-th set flag for k < size; with kTable also
// table[i] = the rank of flag i where it is set and below size, else
// null_slot, for every i < n
template <typename T, bool kTable>
__global__ void __launch_bounds__(kThreads)
write_kernel(const uint8_t* __restrict__ mark, long long n, int size,
             const int* __restrict__ cta_off, T* __restrict__ out, int* __restrict__ table,
             int null_slot) {
  int carry = cta_off[blockIdx.x];
  if (!kTable && carry >= size) return;                   // the same in every thread
  const long long base = (long long)blockIdx.x * kChunk + threadIdx.x * kVec;
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + (long long)r * kRoundBytes;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (i < n) load16(mark, i, n, w);
    int total;
    int k = carry + block_exclusive(count16(w), &total);
    if (i < n) {
      const bool whole = i + kVec <= n;
      int slot[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const bool on = flag_at(w, j);
        slot[j] = on && k < size ? k : null_slot;
        if (kTable && !whole && i + j < n) table[i + j] = slot[j];   // the ragged end
        if (on) {
          if (k < size) out[k] = (T)(i + j);
          ++k;
        }
      }
      if (kTable && whole) {
        int4* dst = reinterpret_cast<int4*>(table + i);
#pragma unroll
        for (int q = 0; q < kVec / 4; ++q)
          dst[q] = make_int4(slot[4 * q], slot[4 * q + 1], slot[4 * q + 2], slot[4 * q + 3]);
      }
    }
    carry += total;
    if (!kTable && carry >= size) break;                  // the same in every thread
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fill_kernel(T* __restrict__ out, int size, T fill, const int* __restrict__ total) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < size && i >= total[0]) out[i] = fill;
}

template <typename T, bool kTable>
cudaError_t compact(const uint8_t* mark, long long n, int size, T fill, T* out, int* table,
                    int null_slot, int* cta_count, int* cta_off, int* total, int* count_out,
                    int* overflow_out, cudaStream_t st) {
  const int nb = (int)((n + kChunk - 1) / kChunk);
  count_kernel<<<nb, kThreads, 0, st>>>(mark, n, cta_count);
  scan_kernel<<<1, kScanThreads, 0, st>>>(cta_count, nb, size, cta_off, total, count_out,
                                          overflow_out);
  write_kernel<T, kTable><<<nb, kThreads, 0, st>>>(mark, n, size, cta_off, out, table,
                                                   null_slot);
  fill_kernel<T><<<(size + kThreads - 1) / kThreads, kThreads, 0, st>>>(out, size, fill, total);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- oct mask

// flags[o] = any of the 8 block bytes of oct o in extra (0 without it), 16
// octs a thread
__global__ void __launch_bounds__(kThreads)
flags_base_kernel(const uint8_t* __restrict__ extra, int no, uint8_t* __restrict__ flags) {
  const long long o = ((long long)blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (o >= no) return;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (extra != nullptr) {
    if (o + kVec <= no) {
      const uint4* src = reinterpret_cast<const uint4*>(extra + 8 * o);
#pragma unroll
      for (int q = 0; q < kVec / 2; ++q) {                // two octs a load
        const uint4 v = src[q];
        if (v.x | v.y) w[(2 * q) >> 2] |= 1u << (8 * ((2 * q) & 3));
        if (v.z | v.w) w[(2 * q + 1) >> 2] |= 1u << (8 * ((2 * q + 1) & 3));
      }
    } else {
      for (int j = 0; o + j < no; ++j) {
        const uint2 v = *reinterpret_cast<const uint2*>(extra + 8 * (o + j));
        if (v.x | v.y) w[j >> 2] |= 1u << (8 * (j & 3));
      }
    }
  }
  if (o + kVec <= no) {
    *reinterpret_cast<uint4*>(flags + o) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int j = 0; o + j < no; ++j) flags[o + j] = flag_at(w, j) ? 1 : 0;
  }
}

// one warp a pool row k < count whose key is an oct key: its flag set when
// any of its mass rows (0-3) is != 0.0f
__global__ void __launch_bounds__(kThreads)
flags_mass_kernel(const float4* __restrict__ pool, const int* __restrict__ keys,
                  const int* __restrict__ count, int nb, int no, uint8_t* __restrict__ flags) {
  const int row = (int)(((long long)blockIdx.x * kThreads + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= nb || row >= count[0]) return;               // the same in the whole warp
  const int key = keys[row];
  if (key < 0 || key >= no) return;
  const float4* src = pool + (long long)row * (kRowFloats / 4);
  bool any = false;
#pragma unroll
  for (int q = 0; q < kMassFloat4 / 32; ++q) {
    const float4 v = src[lane + 32 * q];
    any |= (v.x != 0.0f) | (v.y != 0.0f) | (v.z != 0.0f) | (v.w != 0.0f);
  }
  if (__any_sync(0xffffffffu, any) && lane == 0) flags[key] = 1;
}

// one thread a tile: the octs its block's stencil [lo, lo + span)^3 meets
// inside the grid
__global__ void __launch_bounds__(kThreads)
flags_tiles_kernel(const int* __restrict__ tkeys, int n_tiles, int g, int lo, int span,
                   uint8_t* __restrict__ flags) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_tiles) return;
  const int k = tkeys[t];
  if ((unsigned)k >= (unsigned)(g * g * g)) return;       // the sentinel G^3
  if (t > 0 && tkeys[t - 1] == k) return;                 // the tile before marks these
  const int bx = k / (g * g), by = (k / g) % g, bz = k % g;
  const int hi = lo + span - 1;
  const int z0 = max(bz + lo, 0) >> 3, z1 = min(bz + hi, g - 1) >> 3;
  const int gzo = g >> 3;
  for (int x = max(bx + lo, 0); x <= min(bx + hi, g - 1); ++x)
    for (int y = max(by + lo, 0); y <= min(by + hi, g - 1); ++y)
      for (int z = z0; z <= z1; ++z) flags[((long long)x * g + y) * gzo + z] = 1;
}

// ---------------------------------------------------------------- remap

__global__ void __launch_bounds__(kRowThreads)
remap_rows_kernel(const float4* __restrict__ pool, const int* __restrict__ old_table,
                  const int* __restrict__ keys, int nb, int no, int null_oct,
                  float4* __restrict__ new_pool, int* __restrict__ table) {
  constexpr int kRow4 = kRowFloats / 4;
  constexpr int kPer = kRow4 / kRowThreads;
  const int row = blockIdx.x;
  int src = -1;
  if (row < nb) {
    const int k = keys[row];
    if (k < no) src = old_table[k];                       // null_oct: the old null row
  }
  float4 v[kPer];
  if (src >= 0) {
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      v[q] = __ldg(pool + (long long)src * kRow4 + threadIdx.x + q * kRowThreads);
  } else {
#pragma unroll
    for (int q = 0; q < kPer; ++q) v[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) new_pool[(long long)row * kRow4 + threadIdx.x + q * kRowThreads] = v[q];
  if (row == nb && threadIdx.x == 0) table[no] = null_oct;
}

// ---------------------------------------------------------------- finalize

__global__ void __launch_bounds__(kThreads)
finalize_kernel(const int* __restrict__ tkeys, int n_tiles, const int* __restrict__ table,
                int g, int no, int null_oct, int null_block, int* __restrict__ block,
                int* __restrict__ bcoord, uint8_t* __restrict__ tvalid) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_tiles) return;
  const int n3 = g * g * g;
  const int k = tkeys[t];
  const bool valid = k < n3;
  const int kc = min(k, n3 - 1);
  const int okey = valid ? (k / g) * (g >> 3) + (k % g) / 8 : no;
  const int oslot = table[okey];
  bcoord[t] = valid ? min(kc / (g * g), g - 1) : 0;
  bcoord[n_tiles + t] = valid ? (kc / g) % g : 0;
  bcoord[2 * n_tiles + t] = valid ? kc % g : 0;
  block[t] = valid && oslot != null_oct ? oslot * 8 + (kc & 7) : null_block;
  tvalid[t] = valid ? 1 : 0;
}

}  // namespace partition

using namespace partition;

// The indices of the first `size` set flags of mark u8[n] (16-byte
// aligned), ascending, `fill` after the last: out i64[size]; total i32[1]
// the set flags; cta_count and cta_off i32[ceil(n / 16384)] are scratch.
extern "C" int cm_first_marked(const unsigned char* mark, int n, int size, int fill,
                               long long* out, int* total, int* cta_count, int* cta_off,
                               void* stream) {
  if (n <= 0 || size <= 0) return (int)cudaErrorInvalidValue;
  return (int)compact<long long, false>(mark, n, size, (long long)fill, out, nullptr, 0,
                                        cta_count, cta_off, total, nullptr, nullptr,
                                        (cudaStream_t)stream);
}

// The rebuild's oct flags u8[no] (16-byte aligned): the live rows of pool
// f32[nb + 1, 16, 128] with mass (keys i32[nb], count i32[1]), the tiles'
// block keys of n_models models (tile_keys: their pointers, tile_counts:
// their lengths) dilated by [lo, lo + span)^3, and extra u8[8 no] (the
// halo's blocks; null for none).
extern "C" int cm_partition_oct_mask(const float* pool, const int* keys, const int* count,
                                     int nb, int no, int n_models, const void* const* tile_keys,
                                     const int* tile_counts, const unsigned char* extra, int g,
                                     int lo, int span, unsigned char* flags, void* stream) {
  if (nb <= 0 || no <= 0 || g < 8 || n_models < 0 || n_models > kMaxModels || span <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long vecs = ((long long)no + kVec - 1) / kVec;
  flags_base_kernel<<<(unsigned)((vecs + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      extra, no, flags);
  const long long warps = (long long)nb * 32;
  flags_mass_kernel<<<(unsigned)((warps + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      reinterpret_cast<const float4*>(pool), keys, count, nb, no, flags);
  for (int m = 0; m < n_models; ++m) {
    if (tile_counts[m] <= 0) continue;
    flags_tiles_kernel<<<(tile_counts[m] + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        static_cast<const int*>(tile_keys[m]), tile_counts[m], g, lo, span, flags);
  }
  return (int)cudaGetLastError();
}

// The partition from the flags u8[no]: keys i32[nb] (the first nb set
// flags, no after them), table i32[no + 1] (each oct key's slot or
// null_oct), count and overflow i32[1], and new_pool f32[nb + 1, 16, 128]
// from pool (the old one) through old_table i32[no + 1]; total i32[1],
// cta_count and cta_off i32[ceil(no / 16384)] are scratch.
extern "C" int cm_partition_remap(const unsigned char* flags, int no, int nb, int null_oct,
                                  const float* pool, const int* old_table, int* keys, int* table,
                                  int* count, int* overflow, float* new_pool, int* total,
                                  int* cta_count, int* cta_off, void* stream) {
  if (no <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = compact<int, true>(flags, no, nb, no, keys, table, null_oct, cta_count,
                                             cta_off, total, count, overflow, st);
  if (err != cudaSuccess) return (int)err;
  remap_rows_kernel<<<nb + 1, kRowThreads, 0, st>>>(
      reinterpret_cast<const float4*>(pool), old_table, keys, nb, no, null_oct,
      reinterpret_cast<float4*>(new_pool), table);
  return (int)cudaGetLastError();
}

// Each tile's binding from its block key tkeys i32[n]: block i32[n],
// bcoord i32[3, n], tvalid u8[n], through table i32[no + 1].
extern "C" int cm_partition_finalize_tiles(const int* tkeys, int n, const int* table, int g,
                                           int no, int null_oct, int null_block, int* block,
                                           int* bcoord, unsigned char* tvalid, void* stream) {
  if (n <= 0 || g < 8) return (int)cudaErrorInvalidValue;
  finalize_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      tkeys, n, table, g, no, null_oct, null_block, block, bcoord, tvalid);
  return (int)cudaGetLastError();
}

// What the card gives sub-kernel `which` (0 count, 1 scan, 2 write, 3 fill:
// first_marked's; 4 base, 5 mass, 6 tiles: oct_mask's; 7 write with the
// table, 8 rows: remap's; 9 finalize): out i32[2] = registers per thread,
// resident blocks per SM.
extern "C" int cm_partition_info(int which, int* out) {
  const void* fns[] = {
      (const void*)count_kernel, (const void*)scan_kernel,
      (const void*)write_kernel<long long, false>, (const void*)fill_kernel<long long>,
      (const void*)flags_base_kernel, (const void*)flags_mass_kernel,
      (const void*)flags_tiles_kernel, (const void*)write_kernel<int, true>,
      (const void*)remap_rows_kernel, (const void*)finalize_kernel};
  const int threads[] = {kThreads, kScanThreads, kThreads, kThreads, kThreads, kThreads,
                         kThreads, kThreads, kRowThreads, kThreads};
  if (which < 0 || which >= (int)(sizeof(fns) / sizeof(fns[0])))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fns[which]);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], fns[which], threads[which],
                                                            0);
}
