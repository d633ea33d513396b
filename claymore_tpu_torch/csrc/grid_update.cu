// Grid velocity update over the oct-packed pool: the Hopper kernel K2.
//
// Replaces claymore_tpu/ops/pallas_grid.py:_make_kernel (launched by
// grid_update_pallas): momentum -> velocity, per-axis sticky slab, gravity
// after the clamp, the analytic colliders (resolve_soa, pallas_grid.py:74-90)
// and the SDF-grid colliders (the cached-row branch, pallas_grid.py:92-107),
// massless cells -> 0, and the global max |v|^2 with NaN mapped to inf.
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
// Colliders: a second instantiation takes a small array of packed
// colliders (struct Collider, built once per engine by the wrapper) and
// the collider time t through a pointer (no host sync).  Every thread of
// the block walks the same list, so the branches on type and kind do not
// diverge; the rotation is built only for a collider whose omega is not
// zero, as resolve_soa does.  The collider math keeps the _rn intrinsics
// and the plain version's order of operations; only sinf/cosf and the
// square roots can round apart from PyTorch's, so velocities agree to a few
// ulp.  The no-collider instantiation has no collider code at all and
// stays bit-identical to the plain version.
//
// SDF colliders: a third instantiation (cm_grid_update_sdf) also takes, per
// SDF collider, a node table f32[n0, n1, n2, 4] of (sd, gx, gy, gz), so each
// trilinear corner is one 16-byte load (a 128^3 table is 33.5 MB and stays
// in the 50 MB L2).  The TPU kernel reads a per-cell (sd, n) cache sampled
// once for a static collider and gathered by active row every substep
// (8 KB per row read and written again); here each cell runs resolve_soa's
// transform and samples the table itself, so one kernel serves static and
// animated SDF colliders at any domain size, with no gather pass.  It walks
// the whole list in order, analytic and SDF mixed, as the plain version
// does.  Cells without mass end at v = 0 whatever the colliders do, so they
// skip the colliders, and cells outside the SDF's interior band skip its
// fetch (sd = 1 there): neither changes an output.  The analytic
// instantiations compile without the SDF code.
//
// Layout: pool f32[O+1, 16, 128], rows (channel c, cx), lanes (z8, cy, cz);
// row O is the null oct, whose coordinates are 0 (inside the sticky bound).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowFloats = 16 * 128;

// one collider as the wrapper packs it (24 words)
struct Collider {
  int type;        // 0 half-space, 1 sphere, 2 box, 3 SDF grid
  int kind;        // 0 sticky, 1 slip, 2 separate
  int rotating;    // omega != 0
  int sdf;         // SDF grid: index of its node table
  float friction;
  float vscale;    // dsdt / max(scale, 1e-20)
  float dsdt;
  float radius;    // sphere
  float a[3];      // half-space origin | sphere center | box center | SDF (dx, band lo, band hi)
  float b[3];      // half-space normal | box half extent | SDF node counts (n0, n1, n2)
  float trans[3];
  float trans_vel[3];
  float omega[3];
  float pad1;
};
static_assert(sizeof(Collider) == 96, "Collider must be 24 words");

__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return fa(fa(fm(a[0], b[0]), fm(a[1], b[1])), fm(a[2], b[2]));
}
__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ bool near_face(int c, int b, int g) {
  return c < b || c >= g - b;
}

// Rx(ox t) Ry(oy t) Rz(oz t), row-major (boundary.py:_rot_xyz_scalars)
__device__ void rot_xyz(const float om[3], float t, float r[9]) {
  const float cx = cosf(fm(om[0], t)), sx = sinf(fm(om[0], t));
  const float cy = cosf(fm(om[1], t)), sy = sinf(fm(om[1], t));
  const float cz = cosf(fm(om[2], t)), sz = sinf(fm(om[2], t));
  const float rx[9] = {1.0f, 0.0f, 0.0f, 0.0f, cx, -sx, 0.0f, sx, cx};
  const float ry[9] = {cy, 0.0f, sy, 0.0f, 1.0f, 0.0f, -sy, 0.0f, cy};
  const float rz[9] = {cz, -sz, 0.0f, sz, cz, 0.0f, 0.0f, 0.0f, 1.0f};
  float m[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      m[3 * i + j] = fa(fa(fm(rx[3 * i], ry[j]), fm(rx[3 * i + 1], ry[3 + j])),
                        fm(rx[3 * i + 2], ry[6 + j]));
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r[3 * i + j] = fa(fa(fm(m[3 * i], rz[j]), fm(m[3 * i + 1], rz[3 + j])),
                        fm(m[3 * i + 2], rz[6 + j]));
}

// SignedDistanceCollider.sdf_and_normal_soa: trilinear (sd, grad) from the
// node table, base node clipped to [0, n0 - 2] on every axis, a corner past
// a shorter axis's end reading its last node, sd = 1 outside the band
__device__ float sdf_grid(const Collider& c, const float4* __restrict__ tab,
                          const float x[3], float n[3]) {
  const float dx = c.a[0], lo = c.a[1], hi = c.a[2];
  const int n0 = (int)c.b[0], n1 = (int)c.b[1], n2 = (int)c.b[2];
  if (!(x[0] >= lo && x[0] < hi && x[1] >= lo && x[1] < hi && x[2] >= lo &&
        x[2] < hi))
    return 1.0f;                       // no fetch: outside the band
  int c0[3];
  float fr[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float xc = fd(x[k], dx);
    c0[k] = min(max((int)floorf(xc), 0), n0 - 2);
    fr[k] = fs(xc, (float)c0[k]);
  }
  float sd = 0.0f, g[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float wx = i == 0 ? fs(1.0f, fr[0]) : fr[0];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float wy = j == 0 ? fs(1.0f, fr[1]) : fr[1];
      const size_t row = (size_t)(c0[0] + i) * n1 + min(c0[1] + j, n1 - 1);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float wz = k == 0 ? fs(1.0f, fr[2]) : fr[2];
        const float w = fm(fm(wx, wy), wz);
        const float4 e = __ldg(&tab[row * n2 + min(c0[2] + k, n2 - 1)]);
        sd = fa(sd, fm(w, e.x));
        g[0] = fa(g[0], fm(w, e.y));
        g[1] = fa(g[1], fm(w, e.z));
        g[2] = fa(g[2], fm(w, e.w));
      }
    }
  }
  const float den = fmaxf(sqrtf(dot3(g, g)), 1e-20f);
#pragma unroll
  for (int k = 0; k < 3; ++k) n[k] = fd(g[k], den);
  return sd;
}

// signed distance and outward normal in material space (sdf_and_normal_soa)
template <bool kSdf>
__device__ float sdf_normal(const Collider& c, const float4* const* tables,
                            const float x[3], float n[3]) {
  if (kSdf && c.type == 3) return sdf_grid(c, tables[c.sdf], x, n);
  if (c.type == 0) {
    float d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) { d[k] = fs(x[k], c.a[k]); n[k] = c.b[k]; }
    return dot3(d, c.b);
  }
  if (c.type == 1) {
    float d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = fs(x[k], c.a[k]);
    const float r = sqrtf(dot3(d, d));
    const float inv = fd(1.0f, fmaxf(r, 1e-20f));
#pragma unroll
    for (int k = 0; k < 3; ++k) n[k] = fm(d[k], inv);
    return fs(r, c.radius);
  }
  float d[3], o[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    d[k] = fs(fabsf(fs(x[k], c.a[k])), c.b[k]);
    o[k] = fmaxf(d[k], 0.0f);
  }
  const float dmax = fmaxf(fmaxf(d[0], d[1]), d[2]);
  const float sd = fa(sqrtf(dot3(o, o)), fminf(dmax, 0.0f));
  // the axis of largest d, first one on ties
  const bool is0 = d[0] >= dmax;
  const bool is1 = !is0 && d[1] >= dmax;
  const bool is2 = !is0 && !is1;
  const bool sel[3] = {is0, is1, is2};
#pragma unroll
  for (int k = 0; k < 3; ++k) n[k] = sel[k] ? sgn(fs(x[k], c.a[k])) : 0.0f;
  const float inv = fd(1.0f, fmaxf(sqrtf(dot3(n, n)), 1e-20f));
#pragma unroll
  for (int k = 0; k < 3; ++k) n[k] = fm(n[k], inv);
  return sd;
}

// velocity projection in the object frame (boundary.py:_project_soa)
__device__ void project(const Collider& c, const float vr[3], const float n[3],
                        float out[3]) {
  if (c.kind == 0) {
    out[0] = out[1] = out[2] = 0.0f;
    return;
  }
  const float vdn = dot3(vr, n);
  float tang[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) tang[k] = fs(vr[k], fm(n[k], vdn));
  const bool slip = c.kind == 1;
  const bool approaching = vdn < 0.0f;
  if (slip ? c.friction <= 0.0f : c.friction == 0.0f) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      out[k] = (slip || approaching) ? tang[k] : vr[k];
    return;
  }
  const float vn = sqrtf(dot3(tang, tang));
  const float scl = fa(1.0f, fd(fm(vdn, c.friction), fmaxf(vn, 1e-20f)));
  const bool stop = fm(-vdn, c.friction) >= vn;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    out[k] = approaching ? (stop ? 0.0f : fm(tang[k], scl))
                         : (slip ? tang[k] : vr[k]);
}

// one collider on one cell (ColliderBase.resolve_soa)
template <bool kSdf>
__device__ void resolve(const Collider& c, const float4* const* tables, float t,
                        const float x[3], float v[3]) {
  const float s = fa(1.0f, fm(c.dsdt, t));
  float x_mt[3], x0[3], xm[3], r[9];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x_mt[k] = fs(x[k], fa(c.trans[k], fm(c.trans_vel[k], t)));
    x0[k] = fd(x_mt[k], s);
    xm[k] = x0[k];
  }
  if (c.rotating) {
    rot_xyz(c.omega, t, r);
#pragma unroll
    for (int k = 0; k < 3; ++k)   // X = R^T x0
      xm[k] = fa(fa(fm(r[k], x0[0]), fm(r[3 + k], x0[1])), fm(r[6 + k], x0[2]));
  }
  float n[3];
  const float sd = sdf_normal<kSdf>(c, tables, xm, n);
  if (!(sd <= 0.0f)) return;
  if (c.rotating) {
    const float nm[3] = {n[0], n[1], n[2]};
#pragma unroll
    for (int k = 0; k < 3; ++k)
      n[k] = fa(fa(fm(r[3 * k], nm[0]), fm(r[3 * k + 1], nm[1])),
                fm(r[3 * k + 2], nm[2]));
  }
  float v_obj[3], vr[3], proj[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int k1 = (k + 1) % 3, k2 = (k + 2) % 3;
    v_obj[k] = fa(fa(fs(fm(c.omega[k1], x_mt[k2]), fm(c.omega[k2], x_mt[k1])),
                     fm(x_mt[k], c.vscale)),
                  c.trans_vel[k]);
    vr[k] = fs(v[k], v_obj[k]);
  }
  project(c, vr, n, proj);
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = fa(proj[k], v_obj[k]);
}

template <bool kColliders, bool kSdf>
__global__ void __launch_bounds__(512)
grid_update_kernel(const float* __restrict__ pool,
                   const int* __restrict__ keys,
                   float* __restrict__ pool_v,
                   float* __restrict__ max_vel_sqr,
                   const float* __restrict__ dt_ptr,
                   const Collider* __restrict__ colliders,
                   int num_colliders,
                   const float4* const* __restrict__ sdf_tables,
                   const float* __restrict__ t_ptr,
                   int num_keys, int g, int gzo, int num_oct_keys,
                   int bound_blocks, float gx, float gy, float gz, float dx) {
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
  float v[3];
  dst[off] = m;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float vc = __fmul_rn(src[(4 + 4 * c) * 128 + off], minv);
    v[c] = __fadd_rn(keep[c] ? vc : 0.0f, __fmul_rn(gacc[c], dt));
  }
  if (kColliders && (!kSdf || has)) {
    const float t = *t_ptr;
    const float x[3] = {
        fm((float)(bx * 4 + cx), dx),
        fm((float)(by * 4 + ((lane >> 2) & 3)), dx),
        fm((float)(bz * 4 + (lane & 3)), dx)};
    for (int i = 0; i < num_colliders; ++i)
      resolve<kSdf>(colliders[i], sdf_tables, t, x, v);
  }
  float vsq = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v[c] = has ? v[c] : 0.0f;
    dst[(4 + 4 * c) * 128 + off] = v[c];
    vsq = c == 0 ? __fmul_rn(v[c], v[c]) : __fadd_rn(vsq, __fmul_rn(v[c], v[c]));
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
    float w = threadIdx.x < 16 ? warp_max[threadIdx.x] : 0.0f;
#pragma unroll
    for (int s = 8; s > 0; s >>= 1)
      w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, s));
    if (threadIdx.x == 0 && w > 0.0f)
      atomicMax(reinterpret_cast<int*>(max_vel_sqr), __float_as_int(w));
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
  grid_update_kernel<false, false><<<num_rows, 512, 0, (cudaStream_t)stream>>>(
      pool, keys, pool_v, max_vel_sqr, dt, nullptr, 0, nullptr, nullptr,
      num_keys, g, gzo, num_oct_keys, bound_blocks, gx, gy, gz, 0.0f);
  return (int)cudaGetLastError();
}

extern "C" int cm_grid_update_colliders(
    const float* pool, const int* keys, float* pool_v, float* max_vel_sqr,
    const float* dt, const void* colliders, int num_colliders, const float* t,
    int num_rows, int num_keys, int g, int gzo, int num_oct_keys,
    int bound_blocks, float gx, float gy, float gz, float dx, void* stream) {
  if (num_rows <= 0 || num_colliders <= 0) return (int)cudaErrorInvalidValue;
  grid_update_kernel<true, false><<<num_rows, 512, 0, (cudaStream_t)stream>>>(
      pool, keys, pool_v, max_vel_sqr, dt,
      static_cast<const Collider*>(colliders), num_colliders, nullptr, t,
      num_keys, g, gzo, num_oct_keys, bound_blocks, gx, gy, gz, dx);
  return (int)cudaGetLastError();
}

// sdf_tables: a device array of num_sdf pointers, one node table each
extern "C" int cm_grid_update_sdf(
    const float* pool, const int* keys, float* pool_v, float* max_vel_sqr,
    const float* dt, const void* colliders, int num_colliders,
    const void* sdf_tables, int num_sdf, const float* t, int num_rows,
    int num_keys, int g, int gzo, int num_oct_keys, int bound_blocks,
    float gx, float gy, float gz, float dx, void* stream) {
  if (num_rows <= 0 || num_colliders <= 0 || num_sdf <= 0 || sdf_tables == nullptr)
    return (int)cudaErrorInvalidValue;
  grid_update_kernel<true, true><<<num_rows, 512, 0, (cudaStream_t)stream>>>(
      pool, keys, pool_v, max_vel_sqr, dt,
      static_cast<const Collider*>(colliders), num_colliders,
      static_cast<const float4* const*>(sdf_tables), t, num_keys, g, gzo,
      num_oct_keys, bound_blocks, gx, gy, gz, dx);
  return (int)cudaGetLastError();
}
