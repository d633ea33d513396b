// Grid velocity update over the oct-packed pool: the Hopper kernel K2.
//
// Replaces claymore_tpu/ops/pallas_grid.py:_make_kernel (launched by
// grid_update_pallas): momentum -> velocity, per-axis sticky slab, gravity
// after the clamp, massless cells -> 0, and the global max |v|^2 with NaN
// mapped to inf.  Colliders are not part of this kernel yet; the wrapper
// refuses them.
//
// Bound: device memory.  Each cell reads 16 bytes (m, 3 momenta) and writes
// 16, with a handful of flops, so one pass over the pool at 3.35 TB/s is the
// floor (65537 rows x 8 KB x 2 = 1.07 GB, ~0.32 ms on an H100 SXM).  The
// design spends nothing beyond that pass: one block per pool row (512
// threads = 4 cx x 128 lanes), so every warp reads and writes 128
// contiguous bytes per channel row; the row's block coordinates come from
// its oct key in registers; the max reduces in registers and shared memory
// and ends in ONE atomicMax per block on the float's bit pattern (valid
// because |v|^2 >= 0; +inf orders above every finite value), into a device
// scalar the wrapper zeroes.  Products and sums use the _rn intrinsics so
// the compiler cannot contract them into FMAs: the kernel then rounds like
// the plain PyTorch version, and the mass rows are copied bit for bit.
//
// Layout: pool f32[O+1, 16, 128], rows (channel c, cx), lanes (z8, cy, cz);
// row O is the null oct, whose coordinates are 0 (inside the sticky bound).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowFloats = 16 * 128;

__device__ __forceinline__ bool near_face(int c, int b, int g) {
  return c < b || c >= g - b;
}

__global__ void __launch_bounds__(512)
grid_update_kernel(const float* __restrict__ pool,
                   const int* __restrict__ keys,
                   float* __restrict__ pool_v,
                   float* __restrict__ max_vel_sqr,
                   const float* __restrict__ dt_ptr,
                   int num_keys, int g, int gzo, int num_oct_keys,
                   int bound_blocks, float gx, float gy, float gz) {
  const int row = blockIdx.x;
  const int cx = threadIdx.x >> 7;
  const int lane = threadIdx.x & 127;

  int bx = 0, by = 0, bzo = 0;          // null row -> coordinate 0
  if (row < num_keys) {
    int k = min(keys[row], num_oct_keys - 1);
    bzo = k % gzo;
    by = (k / gzo) % g;
    bx = min(k / (gzo * g), g - 1);
  }
  const int bz = bzo * 8 + (lane >> 4);
  const bool keep_x = !near_face(bx, bound_blocks, g);
  const bool keep_y = !near_face(by, bound_blocks, g);
  const bool keep_z = !near_face(bz, bound_blocks, g);

  const float dt = *dt_ptr;
  const float* src = pool + (size_t)row * kRowFloats;
  float* dst = pool_v + (size_t)row * kRowFloats;
  const int off = cx * 128 + lane;

  const float m = src[off];
  const bool has = m > 0.0f;
  const float minv = has ? __fdiv_rn(1.0f, m) : 0.0f;
  const float gacc[3] = {gx, gy, gz};
  const bool keep[3] = {keep_x, keep_y, keep_z};
  float vsq = 0.0f;
  dst[off] = m;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = __fmul_rn(src[(4 + 4 * c) * 128 + off], minv);
    v = __fadd_rn(keep[c] ? v : 0.0f, __fmul_rn(gacc[c], dt));
    v = has ? v : 0.0f;
    dst[(4 + 4 * c) * 128 + off] = v;
    vsq = c == 0 ? __fmul_rn(v, v) : __fadd_rn(vsq, __fmul_rn(v, v));
  }
  if (isnan(vsq)) vsq = INFINITY;
  if (!has) vsq = 0.0f;

  // block max: warp shuffle, then one warp over the 16 warp maxima
  __shared__ float warp_max[16];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    vsq = fmaxf(vsq, __shfl_xor_sync(0xffffffffu, vsq, s));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = vsq;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < 16 ? warp_max[threadIdx.x] : 0.0f;
#pragma unroll
    for (int s = 8; s > 0; s >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
    if (threadIdx.x == 0 && v > 0.0f)
      atomicMax(reinterpret_cast<int*>(max_vel_sqr), __float_as_int(v));
  }
}

}  // namespace

extern "C" int cm_grid_update(const float* pool, const int* keys,
                              float* pool_v, float* max_vel_sqr,
                              const float* dt, int num_rows, int num_keys,
                              int g, int gzo, int num_oct_keys,
                              int bound_blocks, float gx, float gy, float gz,
                              void* stream) {
  if (num_rows <= 0) return (int)cudaErrorInvalidValue;
  grid_update_kernel<<<num_rows, 512, 0, (cudaStream_t)stream>>>(
      pool, keys, pool_v, max_vel_sqr, dt, num_keys, g, gzo, num_oct_keys,
      bound_blocks, gx, gy, gz);
  return (int)cudaGetLastError();
}
