// Pool-row gather and read-modify-write in device memory: the Hopper probes
// P5 and P6.
//
// P5 replaces scripts/prof_dma.py:40 dma_gather_bench (its pallas_call is
// made at :89), whose program g DMAs D runs of R consecutive pool rows
// f32[16, 128] from data-dependent starts into VMEM and sums them:
//   out[g] = sum_{d < D} sum_{r < R} pool[idx[g, d] + r]
// which is K1's arena staging (each tile's neighbour rows, 8 KB each).
// P6 replaces scripts/prof_dma.py:189 rmw_bench (its pallas_call at :221),
// whose program g reads its D runs, adds 1 to them and writes them back in
// place (K1's flush of its output arena); out[g] = (g, 0, ...).  The TPU
// grid runs its programs in order and each program reads all its runs
// before it writes any, so a row gains 1.0 once per program whose runs
// cover it (two runs of one program that share a row write the same value),
// added one program after another.
//
// Bound: device memory.  P5 must read each distinct row the runs touch once
// and write G rows (~64,800 of 65,536 rows at the script's (8192, 4, 9):
// 0.60 GB, 0.18 ms at the 3.35 TB/s an H100 SXM is rated for at its 700 W
// limit); the payload, every run read as often as it is named, is 2.42 GB
// (0.72 ms), so no faster way to fetch a named row can come near the bound.
// P6 reads and writes each distinct row once (0.96 GB at (4096, 4, 9),
// 0.29 ms) where the runs name 2.5 times as many row updates.  The adds are
// negligible.  So both designs move each touched row across device memory
// about once.
//
// P6 (cm_prof_rmw), two sub-kernels:
// * rmw_count_kernel, one warp per program: counts into cover i32[O] (zeroed
//   by the wrapper) with integer atomics, exact in any order, each row the
//   program's runs cover once (a run's row already covered by an earlier run
//   of the program is skipped), and writes out[g] (NaN in out[g, 0] when a
//   start lies outside [0, O - R]; that run counts nothing).
// * rmw_stream_kernel, persistent blocks, one warp per row: a row with
//   cover 0 is skipped after one 4-byte read; any other row is loaded once
//   (16 float4 a lane), gains v = v + 1.0f cover times in registers (one add
//   per covering program, the TPU's sequence of adds on any pool: adding the
//   count once would round differently past 2**24) and is stored once.
//
// P5 (cm_prof_dma_gather, cm_prof_dma_gather_ring) runs one of two plans,
// which the wrapper chooses from (O, G, D, R) (probe_kernels.gather_plan):
// * direct: gather_kernel, one block per program, adds its D R rows as they
//   come (part = row_0 + ... + row_{R-1}; acc = acc + part, as the plain
//   version).  Every named row crosses device memory.
// * two_pass, for R > 1 where it moves far fewer bytes: plan_kernel marks each
//   distinct start in slot i32[O] (zeroed by the wrapper; 1 + the largest
//   flat run index k = g D + d naming it, by atomicMax); window_kernel, one
//   block per unit of kUnit pool rows, lists the rows that the windows of
//   its unit's starts span (plus R - 1 rows of halo past the unit), streams
//   each once through a shared-memory ring of R - 1 + U rows and writes
//   W[slot[s] - 1] = row_s + ... + row_{s+R-1} for each start s, in that
//   order; gather_kernel then sums each program's D window sums,
//   acc = ((0 + W_0) + W_1) + ..., the plain version's adds in its order.
//   Rule (the wrapper's, probe_kernels.gather_plan): expected rows moved
//   for G D starts drawn uniformly from [0, O - R), q = 1 - 1 / (O - R).
//   Direct: G D R + G.  Two-pass: the rows the windows cover,
//   O (1 - q^(G D R)), again the halo rows a block's windows reach,
//   (O / kUnit) sum_{m < R} (1 - q^(G D m)), the distinct starts written,
//   (O - R)(1 - q^(G D)), G D sums read back and G rows written.  Two-pass
//   runs where it moves under TWO_PASS_SHARE (0.75) of the direct plan's
//   rows, because it moves them more slowly (three launches, the halo, the
//   sums' scattered reads back): ~2.5-2.75 TB/s against the direct gather's
//   3.0-3.2 on an H100.  At O = 65,536, D = 4: (8192, 4, 9) 134,876 against
//   303,104 rows (0.44): two-pass; (2048, 4, 9) 63,869 against 75,776
//   (0.84) and (8192, 4, 3) 118,186 against 106,496 (1.11): direct.  R = 1
//   (a window is its row) and R > kMaxWindowRows run direct.
// Two variants differ only in how rows reach the adders, the TPU probe's
// double_buffer off and on:
// * dma_gather: 16-byte loads into registers (each thread owns two fixed
//   16-byte lanes of the 2,048-float row, t and t + 256, so a warp's load
//   covers 512 contiguous bytes); window_kernel loads the next U rows while
//   it adds the current ones and keeps its ring in its own lanes of shared
//   memory (no barrier: each thread reads only what it wrote).
// * dma_gather_ring: one thread streams whole rows by cp.async.bulk
//   (bulk_copy.cuh) into a ring of 8 KB slots in shared memory, each slot
//   completing on its mbarrier, U rows a step ahead of the adders; a block
//   barrier per step frees the slots for the next copies.
// A start outside [0, O - R] (the plain versions raise on it) touches no
// memory: P5 writes NaN for its program.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRow4 = 16 * 128 / 4;              // float4 per pool row (512)
constexpr uint32_t kRowBytes = kRow4 * 16;       // 8 KB
constexpr int kGatherSlots = 8;                  // gather_kernel<true>'s ring
constexpr int kGatherStep = kGatherSlots / 2;
constexpr int kUnit = 128;                       // pool rows per window_kernel block
constexpr int kMaxWindowRows = 16;               // the largest R two_pass takes
constexpr int kWindowStep = 4;                   // U of window_kernel<false>
constexpr int kWindowRingStep = 2;               // U of window_kernel<true>
constexpr int kMaxEntries = kUnit + kMaxWindowRows - 1;
constexpr int kBarBytes = 512;                   // mbarriers ahead of a ring

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ bool start_ok(int s, int rows, int run_rows) {
  return s >= 0 && s <= rows - run_rows;
}

__device__ __forceinline__ bool starts_ok(const int* __restrict__ idx, int g, int runs,
                                          int run_rows, int rows) {
  for (int d = 0; d < runs; ++d)
    if (!start_ok(idx[g * runs + d], rows, run_rows)) return false;
  return true;
}

// ---------------------------------------------------------------------------
// P5: the direct gather and the two-pass plan's last pass
// ---------------------------------------------------------------------------

// out[g] = sum_d (src[m(idx[g, d])] + ... + src[m(idx[g, d]) + sum_rows - 1])
// with m(s) = s (direct: src is the pool) or slot[s] - 1 (two_pass: src is
// W, sum_rows 1).  The starts are checked against the pool's rows and
// run_rows whatever src is.
template <bool RING>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float4* __restrict__ src, const int* __restrict__ idx,
              const int* __restrict__ slot, float4* __restrict__ out, int rows, int runs,
              int run_rows, int sum_rows) {
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  float4* dst = out + (size_t)g * kRow4;
  if (!starts_ok(idx, g, runs, run_rows, rows)) {
    const float4 nan4 = make_float4(NAN, NAN, NAN, NAN);
    dst[t] = nan4;
    dst[t + kThreads] = nan4;
    return;
  }
  auto first_row = [&](int d) -> size_t {
    const int s = idx[g * runs + d];
    return (size_t)(slot != nullptr ? slot[s] - 1 : s);
  };
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 acc0 = zero, acc1 = zero, part0 = zero, part1 = zero;
  if constexpr (!RING) {
    for (int d = 0; d < runs; ++d) {
      const float4* r0 = src + first_row(d) * kRow4;
      part0 = r0[t];
      part1 = r0[t + kThreads];
#pragma unroll 4
      for (int r = 1; r < sum_rows; ++r) {
        part0 = add4(part0, r0[(size_t)r * kRow4 + t]);
        part1 = add4(part1, r0[(size_t)r * kRow4 + t + kThreads]);
      }
      acc0 = add4(acc0, part0);
      acc1 = add4(acc1, part1);
    }
  } else {
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    float4* ring = reinterpret_cast<float4*>(smem + kBarBytes);
    const int total = runs * sum_rows;
    // entry k is row k % sum_rows of run k / sum_rows, in slot k % kGatherSlots
    auto issue = [&](int k) {
      const int d = k / sum_rows, r = k - d * sum_rows;
      const int sl = k % kGatherSlots;
      mbar_expect_tx(&bar[sl], kRowBytes);
      bulk_load(ring + sl * kRow4, src + (first_row(d) + r) * kRow4, kRowBytes, &bar[sl]);
    };
    if (t == 0) {
      for (int s = 0; s < kGatherSlots; ++s) mbar_init(&bar[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (t == 0)
      for (int k = 0; k < kGatherStep && k < total; ++k) issue(k);
    for (int k0 = 0; k0 < total; k0 += kGatherStep) {
      // the next step streams into the slots the last step freed
      if (t == 0)
        for (int k = k0 + kGatherStep; k < k0 + 2 * kGatherStep && k < total; ++k) issue(k);
      for (int k = k0; k < k0 + kGatherStep && k < total; ++k) {
        const int sl = k % kGatherSlots;
        mbar_wait(&bar[sl], (uint32_t)(k / kGatherSlots) & 1u);
        const float4 v0 = ring[sl * kRow4 + t];
        const float4 v1 = ring[sl * kRow4 + t + kThreads];
        const int r = k % sum_rows;
        part0 = r == 0 ? v0 : add4(part0, v0);
        part1 = r == 0 ? v1 : add4(part1, v1);
        if (r == sum_rows - 1) {
          acc0 = add4(acc0, part0);
          acc1 = add4(acc1, part1);
        }
      }
      __syncthreads();
    }
  }
  dst[t] = acc0;
  dst[t + kThreads] = acc1;
}

// ---------------------------------------------------------------------------
// P5, two_pass: the plan and the window sums
// ---------------------------------------------------------------------------

// slot[s] = 1 + the largest flat run index naming start s (0: no run starts
// at s); starts outside the pool are left out
__global__ void plan_kernel(const int* __restrict__ idx, int* __restrict__ slot, int rows,
                            int n, int run_rows) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int s = idx[k];
  if (start_ok(s, rows, run_rows)) atomicMax(&slot[s], k + 1);
}

// dynamic shared memory of window_kernel at run_rows rows: the mbarriers
// (RING), then a ring of run_rows - 1 + 2U (RING) or run_rows - 1 + U slots
__host__ __device__ constexpr int window_slots(bool ring, int run_rows) {
  return ring ? run_rows - 1 + 2 * kWindowRingStep : run_rows - 1 + kWindowStep;
}
__host__ __device__ constexpr size_t window_smem(bool ring, int run_rows) {
  return kBarBytes + (size_t)window_slots(ring, run_rows) * kRowBytes;
}
static_assert(window_slots(true, kMaxWindowRows) * 8 <= kBarBytes, "mbarriers fit");
static_assert(kMaxEntries <= kThreads, "a thread per candidate row of a window block");
static_assert(window_smem(false, kMaxWindowRows) <= 200 * 1024 &&
              window_smem(true, kMaxWindowRows) <= 200 * 1024,
              "a window ring at kMaxWindowRows fits one block's shared memory");

// One block per unit [b, e) of kUnit pool rows: W[slot[s] - 1] for each
// start s in the unit.  The entries are the rows that some window [s, s + R)
// of the unit spans, in order (at most kUnit + R - 1, the halo past e
// included); a window is complete at the entry of its last row, and its R
// rows are the R entries ending there.
template <bool RING>
__global__ void __launch_bounds__(kThreads)
window_kernel(const float4* __restrict__ pool, const int* __restrict__ slot,
              float4* __restrict__ wsum, int rows, int run_rows) {
  __shared__ int e_row[kMaxEntries];     // pool row of entry k
  __shared__ int e_win[kMaxEntries];     // W index of the window ending there, or -1
  __shared__ int u_slot[kUnit];          // slot[] of the unit's rows
  __shared__ int warp_n[kThreads / 32];
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x * kUnit;
  const int e = min(b + kUnit, rows);
  const int R = run_rows;
  for (int i = t; i < kUnit; i += kThreads) u_slot[i] = b + i < e ? slot[b + i] : 0;
  __syncthreads();

  // the entries: row x = b + t is needed if a start of the unit lies in
  // [x - R + 1, x]; compacted in order by a ballot per warp
  const int x = b + t;
  bool need = false;
  if (t < kUnit + R - 1 && x < rows)
    for (int s = max(b, x - R + 1); s <= min(x, e - 1); ++s) need |= u_slot[s - b] > 0;
  const unsigned ballot = __ballot_sync(0xffffffffu, need);
  if (lane == 0) warp_n[warp] = __popc(ballot);
  __syncthreads();
  int k = __popc(ballot & ((1u << lane) - 1u));
  int n = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    k += w < warp ? warp_n[w] : 0;
    n += warp_n[w];
  }
  if (need) {
    e_row[k] = x;
    const int s = x - R + 1;
    e_win[k] = s >= b && s < e ? u_slot[s - b] - 1 : -1;
  }
  __syncthreads();

  const int M = window_slots(RING, R);
  float4* ring = reinterpret_cast<float4*>(smem + kBarBytes);
  // the window ending at entry k, on this thread's lanes, in order
  auto window = [&](int k) {
    const int w = e_win[k];
    if (w < 0) return;
    const int k0 = k - R + 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lane4 = t + h * kThreads;
      float4 part = ring[(k0 % M) * kRow4 + lane4];
      for (int r = 1; r < R; ++r) part = add4(part, ring[((k0 + r) % M) * kRow4 + lane4]);
      wsum[(size_t)w * kRow4 + lane4] = part;
    }
  };

  if constexpr (!RING) {
    constexpr int U = kWindowStep;
    float4 cur[U][2], nxt[U][2];
    auto load = [&](int k0, float4 (&v)[U][2]) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k0 + u < n) {
          const float4* src = pool + (size_t)e_row[k0 + u] * kRow4;
          v[u][0] = src[t];
          v[u][1] = src[t + kThreads];
        }
    };
    load(0, cur);
    for (int k0 = 0; k0 < n; k0 += U) {
      if (k0 + U < n) load(k0 + U, nxt);      // in flight while this step adds
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k0 + u < n) {
          ring[((k0 + u) % M) * kRow4 + t] = cur[u][0];
          ring[((k0 + u) % M) * kRow4 + t + kThreads] = cur[u][1];
        }
      for (int u = 0; u < U && k0 + u < n; ++u) window(k0 + u);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        cur[u][0] = nxt[u][0];
        cur[u][1] = nxt[u][1];
      }
    }
  } else {
    constexpr int U = kWindowRingStep;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    auto issue = [&](int k) {
      const int sl = k % M;
      mbar_expect_tx(&bar[sl], kRowBytes);
      bulk_load(ring + sl * kRow4, pool + (size_t)e_row[k] * kRow4, kRowBytes, &bar[sl]);
    };
    if (t == 0) {
      for (int s = 0; s < M; ++s) mbar_init(&bar[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (t == 0)
      for (int k = 0; k < U && k < n; ++k) issue(k);
    for (int k0 = 0; k0 < n; k0 += U) {
      // entries k0 + U .. k0 + 2U - 1 replace k0 + U - M .. k0 - R, which the
      // windows of this step no longer read
      if (t == 0)
        for (int k = k0 + U; k < k0 + 2 * U && k < n; ++k) issue(k);
      for (int k = k0; k < k0 + U && k < n; ++k) {
        mbar_wait(&bar[k % M], (uint32_t)(k / M) & 1u);
        window(k);
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// P6: count, then stream
// ---------------------------------------------------------------------------

// one warp per program: cover[x] += 1 for each row x of the union of its
// valid runs; out[g] = (g or NaN, 0, ..., 0)
__global__ void rmw_count_kernel(const int* __restrict__ idx, int* __restrict__ cover,
                                 float* __restrict__ out, int rows, int programs, int runs,
                                 int run_rows) {
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= programs) return;
  const int* st = idx + (size_t)g * runs;
  bool ok = true;
  for (int d0 = 0; d0 < runs; d0 += 32) {
    const int d = d0 + lane;
    const int s = d < runs ? st[d] : 0;
    const bool valid = d < runs && start_ok(s, rows, run_rows);
    ok &= __all_sync(0xffffffffu, d >= runs || valid) != 0;
    if (!valid) continue;
    for (int r = 0; r < run_rows; ++r) {
      const int x = s + r;
      bool covered = false;
      for (int j = 0; j < d && !covered; ++j) {
        const int sj = st[j];
        covered = start_ok(sj, rows, run_rows) && sj <= x && x - sj < run_rows;
      }
      if (!covered) atomicAdd(&cover[x], 1);
    }
  }
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (lane == 0) v.x = ok ? (float)g : NAN;
  reinterpret_cast<float4*>(out + (size_t)g * 128)[lane] = v;
}

// persistent blocks, one warp per row: rows with cover 0 are skipped; the
// others are read once, gain 1.0 cover times in registers, are written once
__global__ void __launch_bounds__(kThreads)
rmw_stream_kernel(float4* __restrict__ pool, const int* __restrict__ cover, int rows) {
  constexpr int kPer = kRow4 / 32;   // float4 per lane (16)
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kThreads / 32);
  const float4 one = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  for (int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); row < rows;
       row += warps) {
    const int c = cover[row];
    if (c == 0) continue;
    float4* p = pool + (size_t)row * kRow4 + lane;
    float4 v[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) v[q] = p[q * 32];
    for (int i = 0; i < c; ++i) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) v[q] = add4(v[q], one);
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) p[q * 32] = v[q];
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// dynamic shared memory above 48 KB has to be allowed per kernel first
cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

size_t gather_smem(bool ring) {
  return ring ? kBarBytes + (size_t)kGatherSlots * kRowBytes : 0;
}

template <bool RING>
int launch_gather(const float* pool, const int* idx, float* out, int* slot, float* wsum,
                  int rows, int programs, int runs, int run_rows, int plan, void* stream) {
  if (rows <= 0 || programs <= 0 || runs <= 0 || run_rows <= 0 || (plan != 0 && plan != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float4* src = reinterpret_cast<const float4*>(pool);
  const int* sl = nullptr;
  int sum_rows = run_rows;
  cudaError_t err;
  if (plan == 1) {
    if (run_rows < 2 || run_rows > kMaxWindowRows || slot == nullptr || wsum == nullptr)
      return (int)cudaErrorInvalidValue;
    const int n = programs * runs;
    plan_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(idx, slot, rows, n,
                                                                   run_rows);
    const size_t smem = window_smem(RING, run_rows);
    err = allow_smem((const void*)window_kernel<RING>, smem);
    if (err != cudaSuccess) return (int)err;
    window_kernel<RING><<<(rows + kUnit - 1) / kUnit, kThreads, smem, st>>>(
        src, slot, reinterpret_cast<float4*>(wsum), rows, run_rows);
    src = reinterpret_cast<const float4*>(wsum);
    sl = slot;
    sum_rows = 1;
  }
  err = allow_smem((const void*)gather_kernel<RING>, gather_smem(RING));
  if (err != cudaSuccess) return (int)err;
  gather_kernel<RING><<<programs, kThreads, gather_smem(RING), st>>>(
      src, idx, sl, reinterpret_cast<float4*>(out), rows, runs, run_rows, sum_rows);
  return (int)cudaGetLastError();
}

int stream_blocks(int* blocks) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rmw_stream_kernel, kThreads, 0);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  return 0;
}

}  // namespace

// P5.  plan 0: direct (slot and wsum unused); plan 1: two_pass, slot
// i32[rows] zeroed and wsum f32[programs * runs, 16, 128] as scratch
extern "C" int cm_prof_dma_gather(const float* pool, const int* idx, float* out, int* slot,
                                  float* wsum, int rows, int programs, int runs,
                                  int run_rows, int plan, void* stream) {
  return launch_gather<false>(pool, idx, out, slot, wsum, rows, programs, runs, run_rows,
                              plan, stream);
}

extern "C" int cm_prof_dma_gather_ring(const float* pool, const int* idx, float* out,
                                       int* slot, float* wsum, int rows, int programs,
                                       int runs, int run_rows, int plan, void* stream) {
  return launch_gather<true>(pool, idx, out, slot, wsum, rows, programs, runs, run_rows,
                             plan, stream);
}

// P6 on pool in place; cover i32[rows] zeroed, as scratch
extern "C" int cm_prof_rmw(float* pool, const int* idx, float* out, int* cover, int rows,
                           int programs, int runs, int run_rows, void* stream) {
  if (rows <= 0 || programs <= 0 || runs <= 0 || run_rows <= 0 || cover == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int warps_per_block = kThreads / 32;
  rmw_count_kernel<<<(programs + warps_per_block - 1) / warps_per_block, kThreads, 0, st>>>(
      idx, cover, out, rows, programs, runs, run_rows);
  int blocks = 0;
  const int err = stream_blocks(&blocks);
  if (err != 0) return err;
  rmw_stream_kernel<<<blocks, kThreads, 0, st>>>(reinterpret_cast<float4*>(pool),
                                                      cover, rows);
  return (int)cudaGetLastError();
}

// what the card gives sub-kernel ``which`` at run_rows rows: out i32[3] =
// registers, blocks per SM, shared memory in bytes (static + dynamic).
// 0 gather_kernel, 1 gather_kernel (ring), 2 plan_kernel, 3 window_kernel,
// 4 window_kernel (ring), 5 rmw_count_kernel, 6 rmw_stream_kernel
extern "C" int cm_prof_dma_info(int which, int run_rows, int* out) {
  if (run_rows < 1 || run_rows > kMaxWindowRows) return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  size_t dyn = 0;
  int threads = kThreads;
  switch (which) {
    case 0: fn = (const void*)gather_kernel<false>; break;
    case 1: fn = (const void*)gather_kernel<true>; dyn = gather_smem(true); break;
    case 2: fn = (const void*)plan_kernel; break;
    case 3: fn = (const void*)window_kernel<false>; dyn = window_smem(false, run_rows); break;
    case 4: fn = (const void*)window_kernel<true>; dyn = window_smem(true, run_rows); break;
    case 5: fn = (const void*)rmw_count_kernel; break;
    case 6: fn = (const void*)rmw_stream_kernel; threads = kThreads; break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(fn, dyn);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[2] = (int)(attr.sharedSizeBytes + dyn);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], fn, threads, dyn);
}
