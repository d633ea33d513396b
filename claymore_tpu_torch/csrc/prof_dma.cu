// Pool-row gather and read-modify-write in device memory: the Hopper probes
// P5 and P6.
//
// P5 replaces scripts/prof_dma.py:dma_gather_bench, a pallas_call whose
// program g DMAs D runs of R consecutive pool rows f32[16, 128] from
// data-dependent starts into VMEM and sums them:
//   out[g] = sum_{d < D} sum_{r < R} pool[idx[g, d] + r]
// which is K1's arena staging (each tile's neighbour rows, 8 KB each).
// P6 replaces scripts/prof_dma.py:rmw_bench, which reads, adds 1 to and
// writes back the same windows in place (K1's flush of its output arena):
//   pool[idx[g, d] + r] += 1 for every d < D, r < R;  out[g] = (g, 0, ...)
//
// Bound: device memory.  P5 must read each distinct row it touches once and
// write G rows (about 64,800 of 65,536 rows at the script's (8192, 4, 9):
// 0.60 GB, 0.18 ms at the 3.35 TB/s an H100 SXM is rated for at its 700 W
// limit); the payload, every run read as often as it is named, is 2.42 GB
// (0.72 ms).  P6 reads and writes each distinct row once (0.96 GB at
// (4096, 4, 9), 0.29 ms).  The adds are negligible.
//
// Design.  One block of 256 threads per program g; each thread owns two
// fixed 16-byte lanes of the 2,048-float row (t and t + 256), so every load
// and store of a warp covers 512 contiguous bytes.  P5 sums in the order d,
// then r, exactly as its plain version: part = row_0 + row_1 + ... + row_R-1,
// acc = acc + part, so kernel and plain version round alike at any pool
// size.  Two variants:
// * dma_gather: plain 16-byte loads; the r loop is unrolled so several rows
//   are in flight per thread.
// * dma_gather_ring: the analogue of the TPU kernel's make_async_copy +
//   semaphores double buffer.  The TPU's (2, D, R, 16, 128) scratch would be
//   576 KB at D R = 36, beyond the 227 KB a block may use, so rows stream
//   through a ring of kSlots 8 KB slots in shared memory, filled with 16-byte
//   cp.async kSlots - 1 rows ahead of the sum.  Each thread copies and reads
//   only its own lanes, so cp.async.wait_group orders them and no barrier is
//   needed.
// P6 adds with the float4 atomicAdd that sm_90 has (rmw): the script's starts
// rng.permutation(O - R)[:G D] are distinct but the windows overlap for
// R > 1, and on the TPU the sequential grid added 1 once per window covering
// a row, which the atomics reproduce in any order (the counts are exact
// integers).  rmw_nonatomic does a plain load-add-store instead: right only
// for disjoint windows, and timed on such, to compare an atomic flush of
// whole rows with a plain read-modify-write.
//
// A start outside [0, O - R] (the plain versions raise on it) touches no
// memory: P5 writes NaN for its program, P6 skips that run and writes NaN
// to out[g, 0].

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRow4 = 16 * 128 / 4;   // float4 per pool row (512)
constexpr int kSlots = 4;             // ring slots of dma_gather_ring (32 KB)

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ bool starts_ok(const int* __restrict__ idx, int g, int runs,
                                          int run_rows, int rows) {
  for (int d = 0; d < runs; ++d) {
    const int st = idx[g * runs + d];
    if (st < 0 || st > rows - run_rows) return false;
  }
  return true;
}

template <bool RING>
__global__ void __launch_bounds__(kThreads)
dma_gather_kernel(const float4* __restrict__ pool, const int* __restrict__ idx,
                  float4* __restrict__ out, int rows, int runs, int run_rows) {
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  float4* dst = out + (size_t)g * kRow4;
  if (!starts_ok(idx, g, runs, run_rows, rows)) {
    const float4 nan4 = make_float4(NAN, NAN, NAN, NAN);
    dst[t] = nan4;
    dst[t + kThreads] = nan4;
    return;
  }
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 acc0 = zero, acc1 = zero, part0 = zero, part1 = zero;
  if constexpr (!RING) {
    for (int d = 0; d < runs; ++d) {
      const float4* src = pool + (size_t)idx[g * runs + d] * kRow4;
      part0 = src[t];
      part1 = src[t + kThreads];
#pragma unroll 4
      for (int r = 1; r < run_rows; ++r) {
        part0 = add4(part0, src[(size_t)r * kRow4 + t]);
        part1 = add4(part1, src[(size_t)r * kRow4 + t + kThreads]);
      }
      acc0 = add4(acc0, part0);
      acc1 = add4(acc1, part1);
    }
  } else {
    __shared__ float4 ring[kSlots][kRow4];
    const int total = runs * run_rows;
    auto issue = [&](int k) {
      const int d = k / run_rows, r = k - d * run_rows;
      const float4* src = pool + ((size_t)idx[g * runs + d] + r) * kRow4;
      __pipeline_memcpy_async(&ring[k % kSlots][t], &src[t], sizeof(float4));
      __pipeline_memcpy_async(&ring[k % kSlots][t + kThreads], &src[t + kThreads],
                              sizeof(float4));
    };
    for (int k = 0; k < kSlots - 1; ++k) {
      if (k < total) issue(k);
      __pipeline_commit();
    }
    for (int k = 0; k < total; ++k) {
      // slot (k - 1) % kSlots was read by this thread in the last iteration
      if (k + kSlots - 1 < total) issue(k + kSlots - 1);
      __pipeline_commit();
      __pipeline_wait_prior(kSlots - 1);      // row k has landed
      const float4 v0 = ring[k % kSlots][t];
      const float4 v1 = ring[k % kSlots][t + kThreads];
      const int r = k % run_rows;
      part0 = r == 0 ? v0 : add4(part0, v0);
      part1 = r == 0 ? v1 : add4(part1, v1);
      if (r == run_rows - 1) {
        acc0 = add4(acc0, part0);
        acc1 = add4(acc1, part1);
      }
    }
  }
  dst[t] = acc0;
  dst[t + kThreads] = acc1;
}

template <bool ATOMIC>
__global__ void __launch_bounds__(kThreads)
rmw_kernel(float4* __restrict__ pool, const int* __restrict__ idx,
           float* __restrict__ out, int rows, int runs, int run_rows) {
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const float4 one = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  bool ok = true;
  for (int d = 0; d < runs; ++d) {
    const int st = idx[g * runs + d];
    if (st < 0 || st > rows - run_rows) {
      ok = false;
      continue;
    }
    float4* win = pool + (size_t)st * kRow4;
    for (int r = 0; r < run_rows; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4* p = win + (size_t)r * kRow4 + t + h * kThreads;
        if constexpr (ATOMIC) {
          atomicAdd(p, one);
        } else {
          *p = add4(*p, one);
        }
      }
    }
  }
  if (t < 128) out[(size_t)g * 128 + t] = t == 0 ? (ok ? (float)g : NAN) : 0.0f;
}

}  // namespace

extern "C" int cm_prof_dma_gather(const float* pool, const int* idx, float* out,
                                  int rows, int programs, int runs, int run_rows,
                                  void* stream) {
  if (rows <= 0 || programs <= 0 || runs <= 0 || run_rows <= 0)
    return (int)cudaErrorInvalidValue;
  dma_gather_kernel<false><<<programs, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(pool), idx, reinterpret_cast<float4*>(out),
      rows, runs, run_rows);
  return (int)cudaGetLastError();
}

extern "C" int cm_prof_dma_gather_ring(const float* pool, const int* idx, float* out,
                                       int rows, int programs, int runs, int run_rows,
                                       void* stream) {
  if (rows <= 0 || programs <= 0 || runs <= 0 || run_rows <= 0)
    return (int)cudaErrorInvalidValue;
  dma_gather_kernel<true><<<programs, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(pool), idx, reinterpret_cast<float4*>(out),
      rows, runs, run_rows);
  return (int)cudaGetLastError();
}

extern "C" int cm_prof_rmw(float* pool, const int* idx, float* out, int rows,
                           int programs, int runs, int run_rows, void* stream) {
  if (rows <= 0 || programs <= 0 || runs <= 0 || run_rows <= 0)
    return (int)cudaErrorInvalidValue;
  rmw_kernel<true><<<programs, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<float4*>(pool), idx, out, rows, runs, run_rows);
  return (int)cudaGetLastError();
}

extern "C" int cm_prof_rmw_nonatomic(float* pool, const int* idx, float* out, int rows,
                                 int programs, int runs, int run_rows, void* stream) {
  if (rows <= 0 || programs <= 0 || runs <= 0 || run_rows <= 0)
    return (int)cudaErrorInvalidValue;
  rmw_kernel<false><<<programs, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<float4*>(pool), idx, out, rows, runs, run_rows);
  return (int)cudaGetLastError();
}
