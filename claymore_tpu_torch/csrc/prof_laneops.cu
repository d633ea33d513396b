// Dynamic lane-offset access in fast memory: the Hopper probes P1-P4.
//
// Replace the four Mosaic probes of scripts/prof_laneops.py, each a
// pallas_call over one f32[16, 128] tile in VMEM with a scalar-prefetched
// shift s:
//   P1 dyn_roll            o[:, j] = x[:, (j + s) % 128]   (pltpu.roll(x, -s, 1))
//   P2 dyn_lane_read       o = x[:, s : s + 32]             0 <= s <= 96
//   P3 dyn_lane_read_wide  o = x[:, s + 112 : s + 144]      x f32[16, 384], 0 <= s <= 240
//   P4 dyn_lane_write      o = 0; o[:, s : s + 32] = 2 x[:, :32];
//                          o[:, s + 32 : s + 48] += x[:, :16]   0 <= s <= 80
// On the TPU they asked whether Mosaic lowers a data-dependent lane offset
// at all, and what it costs; K1 needs such offsets to place particles in
// its arenas.  On the card the question becomes the cost of shared-memory
// reads and writes at a data-dependent offset, which is what K1's arena
// gather (81 reads per particle) and its P2G adds (108 per particle) do.
//
// A lone 8 KB tile measures only the launch, so each kernel takes a grid of
// G tiles, x f32[G, 16, W], one shift per tile s i32[G]; G = 1 with the
// script's tile and shift is the parity case.  Each kernel stages what the
// probe reads into shared memory (the VMEM analogue) with 16-byte loads,
// reads there at the tile's offset (P1-P3) or builds its output tile there
// with a write and a read-modify-write at the offset (P4), and stores with
// consecutive threads on consecutive addresses.  P2 and P3 stage only the
// 16-byte columns their 32-lane window covers (8 or 9 of them), P4 only
// x[:, :32]: the TPU copied the whole tile into VMEM, here that would be
// traffic nothing reads.  Each staged word is touched once or twice, so
// these kernels time the device-memory stream around the offset accesses,
// not the shared-memory rate.
//
// Bound: device memory.  The lanes read and written once: P1 16 KB a tile,
// P2 and P3 4 KB, P4 2 KB read and 8 KB written; at G = 65536 that is
// 0.08-0.32 ms at the 3.35 TB/s an H100 SXM is rated for at its 700 W
// limit, far above the few operations.
//
// P1 and P4 run one block of 256 threads per tile.  For P2 and P3 that
// design paid more per block than its 4 KB moved: 65,536 blocks of about a
// microsecond, 144 of 256 threads loading, a block barrier between loads
// and reads, two scalar stores a thread; it lost to torch.gather.  So P2
// and P3 give each tile one warp and each block 8 tiles: the warp stages
// its 16 x (8 or 9) 16-byte columns in its own slice of shared memory,
// synchronises with __syncwarp only, and writes its 16 x 32 output floats
// as 128 float4s, each assembled from the two staged float4s the window
// straddles (one when the window is 16-byte aligned).  A 128-bit shared
// access serves 8 lanes at a time, which here read 8 consecutive float4s of
// one row: no bank conflicts.  What bounds them is device memory at a
// partial-row pattern: each of a tile's 16 rows gives up 128-144 bytes of
// 512 (P2) or 1,536 (P3), so the DRAM pages they open yield little, and
// the same kernel runs 1.2x faster when every window is 32-byte aligned.
// A grid-stride loop over tiles (8 blocks per SM), with or without the
// next tile's loads in flight, ran 4-8% slower than this one-shot grid:
// the hardware's block scheduler evens out the tail.
//
// A shift outside the window's range (the plain version raises on it) fills
// that tile's output with NaN and touches no memory outside the tile.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;
constexpr int kLanes = 128;

__global__ void __launch_bounds__(kThreads)
dyn_roll_kernel(const float4* __restrict__ x, const int* __restrict__ shifts,
                float* __restrict__ out) {
  __shared__ float tile[kRows * kLanes];
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const float4* src = x + (size_t)g * (kRows * kLanes / 4);
  for (int i = t; i < kRows * kLanes / 4; i += kThreads)
    reinterpret_cast<float4*>(tile)[i] = src[i];
  __syncthreads();
  const int s = shifts[g] & (kLanes - 1);   // Python's s % 128, negatives too
  float* dst = out + (size_t)g * (kRows * kLanes);
#pragma unroll
  for (int k = 0; k < kRows * kLanes / kThreads; ++k) {
    const int e = t + k * kThreads;
    const int row = e >> 7, j = e & (kLanes - 1);
    dst[e] = tile[row * kLanes + ((j + s) & (kLanes - 1))];
  }
}

// P2 (W = 128, BASE = 0, SMAX = 96) and P3 (W = 384, BASE = 112, SMAX = 240):
// the 32 lanes from BASE + s of each row; one warp per tile, 8 per block
constexpr int kWinWarps = kThreads / 32;

template <int W, int BASE, int SMAX>
__global__ void __launch_bounds__(kThreads)
dyn_lane_window_kernel(const float4* __restrict__ x, const int* __restrict__ shifts,
                       float4* __restrict__ out, int tiles) {
  __shared__ float4 stage[kWinWarps][kRows * 9];   // per warp: 16 rows x 9 columns
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4* st = stage[warp];
  const int g = blockIdx.x * kWinWarps + warp;
  if (g >= tiles) return;
  const int s = shifts[g];                 // uniform over the warp
  float4* dst = out + (size_t)g * (kRows * 8);
  if (s < 0 || s > SMAX) {
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[lane + 32 * k] = make_float4(NAN, NAN, NAN, NAN);
    return;
  }
  const int a = BASE + s;                  // first lane of the window
  const int c0 = a >> 2, off = a & 3;
  const int ncol = off ? 9 : 8;
  const float4* src = x + (size_t)g * kRows * (W / 4) + c0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int i = lane + 32 * k;
    if (i < kRows * ncol) {
      const int row = off ? i / 9 : i >> 3;
      const int c = i - row * ncol;
      st[row * 9 + c] = src[row * (W / 4) + c];
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = lane + 32 * k;           // output float4: row e / 8, lanes 4 (e % 8)
    const float4* r = st + (e >> 3) * 9 + (e & 7);
    const float4 lo = r[0];
    float4 o = lo;
    if (off) {
      const float4 hi = r[1];
      o = off == 1 ? make_float4(lo.y, lo.z, lo.w, hi.x)
        : off == 2 ? make_float4(lo.z, lo.w, hi.x, hi.y)
                   : make_float4(lo.w, hi.x, hi.y, hi.z);
    }
    dst[e] = o;
  }
}

int window_blocks(int tiles) { return (tiles + kWinWarps - 1) / kWinWarps; }

// P4: the output tile lives in shared memory; it is zeroed, written at lane
// s and read-modified-written at lane s + 32 there, then stored whole.  The
// two windows are disjoint, so the accumulate needs no barrier after the
// write.  In the accumulate a warp covers two rows 128 words apart: a 2-way
// bank conflict.
__global__ void __launch_bounds__(kThreads)
dyn_lane_write_kernel(const float4* __restrict__ x, const int* __restrict__ shifts,
                      float* __restrict__ out) {
  __shared__ float4 xin[kRows * 8];             // x[:, :32]
  __shared__ float4 otile[kRows * kLanes / 4];  // o
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const int s = shifts[g];
  float4* dst = reinterpret_cast<float4*>(out) + (size_t)g * (kRows * kLanes / 4);
  if (s < 0 || s > 80) {
    for (int i = t; i < kRows * kLanes / 4; i += kThreads)
      dst[i] = make_float4(NAN, NAN, NAN, NAN);
    return;
  }
  if (t < kRows * 8)
    xin[t] = x[((size_t)g * kRows + (t >> 3)) * (kLanes / 4) + (t & 7)];
  for (int i = t; i < kRows * kLanes / 4; i += kThreads)
    otile[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  const float* xf = reinterpret_cast<const float*>(xin);
  float* of = reinterpret_cast<float*>(otile);
  // o[:, s : s + 32] = 2 x[:, :32], two lanes per thread
#pragma unroll
  for (int k = 0; k < kRows * 32 / kThreads; ++k) {
    const int e = t + k * kThreads;
    const int row = e >> 5, j = e & 31;
    of[row * kLanes + s + j] = __fmul_rn(xf[row * 32 + j], 2.0f);
  }
  // o[:, s + 32 : s + 48] += x[:, :16], one lane per thread
  {
    const int row = t >> 4, j = t & 15;
    float* o = of + row * kLanes + s + 32 + j;
    *o = __fadd_rn(*o, xf[row * 32 + j]);
  }
  __syncthreads();
  for (int i = t; i < kRows * kLanes / 4; i += kThreads) dst[i] = otile[i];
}

}  // namespace

extern "C" int cm_prof_dyn_roll(const float* x, const int* shifts, float* out,
                                int tiles, void* stream) {
  if (tiles <= 0) return (int)cudaErrorInvalidValue;
  dyn_roll_kernel<<<tiles, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), shifts, out);
  return (int)cudaGetLastError();
}

extern "C" int cm_prof_dyn_lane_read(const float* x, const int* shifts, float* out,
                                     int tiles, void* stream) {
  if (tiles <= 0) return (int)cudaErrorInvalidValue;
  dyn_lane_window_kernel<128, 0, 96>
      <<<window_blocks(tiles), kThreads, 0, (cudaStream_t)stream>>>(
          reinterpret_cast<const float4*>(x), shifts, reinterpret_cast<float4*>(out),
          tiles);
  return (int)cudaGetLastError();
}

extern "C" int cm_prof_dyn_lane_read_wide(const float* x, const int* shifts,
                                          float* out, int tiles, void* stream) {
  if (tiles <= 0) return (int)cudaErrorInvalidValue;
  dyn_lane_window_kernel<384, 112, 240>
      <<<window_blocks(tiles), kThreads, 0, (cudaStream_t)stream>>>(
          reinterpret_cast<const float4*>(x), shifts, reinterpret_cast<float4*>(out),
          tiles);
  return (int)cudaGetLastError();
}

// registers and blocks per SM of a lane probe: which 0 P2, 1 P3; out i32[3]
// (registers, blocks per SM, static shared memory bytes)
extern "C" int cm_prof_laneops_info(int which, int* out) {
  const void* fn = which == 0 ? (const void*)dyn_lane_window_kernel<128, 0, 96>
                 : which == 1 ? (const void*)dyn_lane_window_kernel<384, 112, 240>
                              : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[2] = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], fn, kThreads, 0);
}

extern "C" int cm_prof_dyn_lane_write(const float* x, const int* shifts, float* out,
                                      int tiles, void* stream) {
  if (tiles <= 0) return (int)cudaErrorInvalidValue;
  dyn_lane_write_kernel<<<tiles, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), shifts, out);
  return (int)cudaGetLastError();
}
