// Grid velocity update over the oct-packed pool: the Hopper kernels K2,
// K2-AC and K2-SDF.
//
// Replaces claymore_tpu/ops/pallas_grid.py:_make_kernel (launched by
// grid_update_pallas): momentum -> velocity, per-axis sticky slab, gravity
// after the clamp, the analytic colliders (resolve_soa, pallas_grid.py:74-90)
// and the SDF-grid colliders (the cached-row branch, pallas_grid.py:92-107),
// massless cells -> 0, and the global max |v|^2 with NaN mapped to inf.
//
// Bound: device memory.  Each cell reads 16 bytes (m, 3 momenta) and writes
// 16, with a handful of flops, so one pass over the pool at 3.35 TB/s is the
// floor (65537 rows x 8 KB x 2 = 1.07 GB, ~0.32 ms on an H100 SXM).  Every
// variant keeps the plain version's rounding: products, sums and quotients
// use the _rn intrinsics, so the compiler cannot contract them into FMAs,
// and the mass rows are copied bit for bit.  The max reduces in registers
// and shared memory and ends in ONE atomicMax per block on the float's bit
// pattern (valid because |v|^2 >= 0; +inf orders above every finite value),
// into a device scalar the wrapper zeroes.
//
// K2 (no colliders, cm_grid_update): one block per pool row, 512 threads =
// 4 cx x 128 lanes, so every warp reads and writes 128 contiguous bytes per
// channel row.  It already runs near the bound and has no collider code.
//
// K2-AC and K2-SDF (grid_collider_kernel<kSdf>): what a collider costs is
// per-cell instructions, L2 traffic and latency, not device memory, so the
// design takes work away from the cells and keeps many rows in flight:
// * Persistent blocks of 128 threads (4 cells a thread, one per cx; SMs x
//   the blocks per SM the runtime reports, cm_grid_update_info) walk the
//   pool rows in a grid-stride loop.  Thread 0 streams each row (8 KB,
//   contiguous) into a kStages-deep shared-memory ring with cp.async.bulk
//   on an mbarrier, kStages - 1 rows ahead; the velocities are written back
//   into the stage and leave as 16-byte stores.  Small blocks matter more
//   than the ring's depth: a row's plan is a short dependent chain (an L2
//   load, the pose, another L2 load), and six or seven blocks an SM overlap
//   them (512-thread blocks, two an SM, ran 1.6x slower on the SDF check;
//   PERF.md).
// * The pose once per block: the threads read the packed colliders and the
//   collider time *t_ptr (no host sync) and keep in shared memory, per
//   collider, s = 1 + dsdt t, the moving origin trans + trans_vel t and R(t)
//   (rot_xyz: sinf/cosf, two 3x3 products), the very operations each cell
//   did before, so every cell gets the same bits.  When s == 1 the
//   divisions by s are skipped (x / 1 == x in IEEE), a branch uniform over
//   the block.  The shared memory is sized by the list, so a launch takes
//   up to kMaxColliders colliders.
// * Cells without mass end at v = 0 whatever the colliders do: they skip
//   the colliders.  Hit test first: a cell computes its signed distance and
//   returns unless sd <= 0; only a hit forms the normal and its reciprocals
//   (the same operations in the same order as before).
// * Rows culled per collider.  While a row's data are in flight, warp
//   i mod 4 plans collider i for the next row (and warp 0 stores the row's
//   block coordinates): one test on the row's 4 x 4 x 32-cell box decides
//   whether any cell of it can have sd <= 0, and the whole block skips the
//   collider for that row when none can (uniform, no divergence; the list
//   is still walked in order).
//   - Analytic colliders: HalfSpace (unit normal), Sphere and Box are
//     1-Lipschitz in material space; the rotation keeps distances and the
//     scale divides them by |s|, so sd(cell) >= sd(centre) - r / |s| with r
//     the half-diagonal of the row's world box (grown by 2^-20 for the
//     normal's and the rotation's own rounding, |n| and ||R|| <= 1 + 2^-22).
//     The row is culled when that bound exceeds a margin dx + 2^-16 S, where
//     S bounds the magnitudes in the chain (|centre|_1 + |half|_1 +
//     |origin|_1) / |s| + the collider's own constants.  The f32 error of a
//     cell's sd, and of the centre's, is a few tens of roundings of numbers
//     no larger than S (position, offset, quotient, three products and sums
//     of the rotation and R's entries, the distance: under 2^-19 S), so
//     2^-16 S covers both with room, and the whole cell dx is spare: a cell
//     the f32 chain puts at sd <= 0 is never culled, one exactly on the
//     surface included.
//   - SDF grids: the row's material-space box is the posed centre plus the
//     half extents |R|^T h / |s| (grown the same way) and the same margin.
//     Outside the band [lo, hi)^3 a cell has sd = 1, so a box that misses
//     the band on one axis is culled.  Inside the band (bound_cells >= 2:
//     every base is floor(x / dx) and every fraction lies in [0, 1)), a
//     cell's sd is a sum of non-negative weights times its 8 corner nodes,
//     one weight at least 1/8, so it is positive when every node it reads
//     is; a table of per-brick minima (8^3 nodes,
//     SignedDistanceCollider.bricks, read by the planning warp's lanes)
//     gives the least node the box can read (its base range widened by one
//     node each way), and the row is culled when that minimum exceeds 1e-30.
//   The plain twin of this decision is ops/grid_kernel.py:collider_row_mask;
//   an optional output (null on the main path) returns the kernel's.
// * The SDF corners are read from the node table through __ldg, in the
//   order and with the clip rules of sdf_normal_soa (the base clipped with
//   n0 on every axis; a corner past a shorter axis reads its last node).
//   Staging a row's nodes in shared memory measured slower on the check
//   and straddle pools and no faster on dambreak_sdf's state (PERF.md).
//
// Layout: pool f32[O+1, 16, 128], rows (channel c, cx), lanes (z8, cy, cz);
// row O is the null oct, whose coordinates are 0 (inside the sticky bound).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kRowFloats = 16 * 128;
constexpr uint32_t kRowBytes = kRowFloats * 4;
constexpr int kThreads = 128;      // collider kernels: 4 warps, 4 cells a thread
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 6;       // blocks per SM the register budget allows
constexpr int kStages = 2;          // rows in the ring: kStages - 1 in flight
constexpr int kMaxColliders = 1024; // the posed list fits a block's shared memory
constexpr int kBrickShift = 3;    // 8^3 nodes per brick of the minima table
constexpr float kRel = 1.52587890625e-05f;   // 2^-16, the margin's share of S
constexpr float kGrow = 1.00000095367431640625f;   // 1 + 2^-20
constexpr float kMinPositive = 1e-30f;

// one collider as the wrapper packs it (24 words)
struct Collider {
  int type;        // 0 half-space, 1 sphere, 2 box, 3 SDF grid
  int kind;        // 0 sticky, 1 slip, 2 separate
  int rotating;    // omega != 0
  int sdf;         // SDF grid: index of its node table
  float friction;
  float vscale;    // dsdt / max(scale, 1e-20)
  float dsdt;
  union {
    float radius;        // sphere
    uint32_t brick_lo;   // SDF grid: address of its brick minima, low word
  };
  float a[3];      // half-space origin | sphere center | box center | SDF (dx, band lo, band hi)
  float b[3];      // half-space normal | box half extent | SDF node counts (n0, n1, n2)
  float trans[3];
  float trans_vel[3];
  float omega[3];
  uint32_t brick_hi;   // SDF grid: address of its brick minima, high word (0: none)
};
static_assert(sizeof(Collider) == 96, "Collider must be 24 words");

// a collider posed at the block's collider time, in shared memory
struct Posed {
  Collider c;
  const float4* tab;     // SDF node table
  const float* bricks;   // SDF brick minima (null: no brick test)
  float s;               // 1 + dsdt t
  float off[3];          // trans + trans_vel t
  float r[9];            // R(t), row-major (rotating colliders)
  int s_one;             // s == 1: no division by s
};

struct Params {
  const float* pool;
  const int* keys;
  float* pool_v;
  float* max_vel_sqr;
  const float* dt_ptr;
  const Collider* colliders;
  const float4* const* sdf_tables;
  const float* t_ptr;
  unsigned char* row_mask;   // optional [num_rows, num_colliders]
  int num_colliders, num_rows, num_keys, g, gzo, num_oct_keys, bound_blocks;
  float gx, gy, gz, dx;
};

__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return fa(fa(fm(a[0], b[0]), fm(a[1], b[1])), fm(a[2], b[2]));
}
__device__ __forceinline__ float l1(const float a[3]) {
  return fa(fa(fabsf(a[0]), fabsf(a[1])), fabsf(a[2]));
}
__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

__device__ __forceinline__ bool near_face(int c, int b, int g) {
  return c < b || c >= g - b;
}

// block coordinates of a pool row (the null row and the rows past the keys
// -> 0; keys past the table -> the last oct)
__device__ __forceinline__ void row_coords(const Params& p, int row, int& bx, int& by,
                                           int& bzo) {
  bx = by = bzo = 0;
  if (row < p.num_keys) {
    const int k = min(p.keys[row], p.num_oct_keys - 1);
    bzo = k % p.gzo;
    by = (k / p.gzo) % p.g;
    bx = min(k / (p.gzo * p.g), p.g - 1);
  }
}

// ---------------------------------------------------------------------------
// K2: no colliders, one block per pool row
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(512)
grid_update_kernel(const float* __restrict__ pool, const int* __restrict__ keys,
                   float* __restrict__ pool_v, float* __restrict__ max_vel_sqr,
                   const float* __restrict__ dt_ptr, int num_keys, int g, int gzo,
                   int num_oct_keys, int bound_blocks, float gx, float gy, float gz) {
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

// ---------------------------------------------------------------------------
// K2-AC / K2-SDF: the collider math
// ---------------------------------------------------------------------------

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

// the block's prologue: one collider posed at time t
__device__ void pose(const Collider& c, const float4* const* tables, float t, Posed& out) {
  out.c = c;
  out.s = fa(1.0f, fm(c.dsdt, t));
  out.s_one = out.s == 1.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) out.off[k] = fa(c.trans[k], fm(c.trans_vel[k], t));
  if (c.rotating) {
    float r[9];
    rot_xyz(c.omega, t, r);
#pragma unroll
    for (int k = 0; k < 9; ++k) out.r[k] = r[k];
  }
  const bool grid = c.type == 3;
  out.tab = (grid && tables != nullptr) ? tables[c.sdf] : nullptr;
  out.bricks = grid ? reinterpret_cast<const float*>(((uint64_t)c.brick_hi << 32) |
                                                     (uint64_t)c.brick_lo)
                    : nullptr;
}

// world -> relative to the moving origin (x_mt) and material frame (xm)
__device__ __forceinline__ void to_material(const Posed& P, const float x[3], float x_mt[3],
                                            float xm[3]) {
  float x0[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x_mt[k] = fs(x[k], P.off[k]);
    x0[k] = P.s_one ? x_mt[k] : fd(x_mt[k], P.s);
  }
  if (P.c.rotating) {
#pragma unroll
    for (int k = 0; k < 3; ++k)   // X = R^T x0
      xm[k] = fa(fa(fm(P.r[k], x0[0]), fm(P.r[3 + k], x0[1])), fm(P.r[6 + k], x0[2]));
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) xm[k] = x0[k];
  }
}

// signed distance of an analytic collider in material space (no normal)
__device__ __forceinline__ float analytic_sd(const Collider& c, const float x[3]) {
  float d[3];
  if (c.type == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = fs(x[k], c.a[k]);
    return dot3(d, c.b);
  }
  if (c.type == 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = fs(x[k], c.a[k]);
    return fs(sqrtf(dot3(d, d)), c.radius);
  }
  float o[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    d[k] = fs(fabsf(fs(x[k], c.a[k])), c.b[k]);
    o[k] = fmaxf(d[k], 0.0f);
  }
  const float dmax = fmaxf(fmaxf(d[0], d[1]), d[2]);
  return fa(sqrtf(dot3(o, o)), fminf(dmax, 0.0f));
}

// outward normal of an analytic collider at a hit (sdf_and_normal_soa)
__device__ __forceinline__ void analytic_normal(const Collider& c, const float x[3],
                                                float n[3]) {
  if (c.type == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) n[k] = c.b[k];
    return;
  }
  float d[3];
  if (c.type == 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = fs(x[k], c.a[k]);
    const float inv = fd(1.0f, fmaxf(sqrtf(dot3(d, d)), 1e-20f));
#pragma unroll
    for (int k = 0; k < 3; ++k) n[k] = fm(d[k], inv);
    return;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = fs(fabsf(fs(x[k], c.a[k])), c.b[k]);
  const float dmax = fmaxf(fmaxf(d[0], d[1]), d[2]);
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
}

// a cell's trilinear stencil in an SDF node table: base node clipped to
// [0, n0 - 2] on every axis, a corner past a shorter axis's end reading its
// last node
struct Stencil {
  int c0[3], n1, n2;
  float fr[3];
};

__device__ __forceinline__ float4 corner(const Posed& P, const Stencil& st, int i, int j,
                                         int k) {
  const int ix = st.c0[0] + i;
  const int iy = min(st.c0[1] + j, st.n1 - 1);
  const int iz = min(st.c0[2] + k, st.n2 - 1);
  return __ldg(&P.tab[((size_t)ix * st.n1 + iy) * st.n2 + iz]);
}

// SignedDistanceCollider.sdf_and_normal_soa's value: sd = 1 outside the band
__device__ __forceinline__ float sdf_value(const Posed& P, const float x[3], Stencil& st) {
  const Collider& c = P.c;
  const float dx = c.a[0], lo = c.a[1], hi = c.a[2];
  const int n0 = (int)c.b[0];
  st.n1 = (int)c.b[1];
  st.n2 = (int)c.b[2];
  if (!(x[0] >= lo && x[0] < hi && x[1] >= lo && x[1] < hi && x[2] >= lo && x[2] < hi))
    return 1.0f;                       // no fetch: outside the band
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float xc = fd(x[k], dx);
    st.c0[k] = min(max((int)floorf(xc), 0), n0 - 2);
    st.fr[k] = fs(xc, (float)st.c0[k]);
  }
  float sd = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float wx = i == 0 ? fs(1.0f, st.fr[0]) : st.fr[0];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float wy = j == 0 ? fs(1.0f, st.fr[1]) : st.fr[1];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float wz = k == 0 ? fs(1.0f, st.fr[2]) : st.fr[2];
        sd = fa(sd, fm(fm(fm(wx, wy), wz), corner(P, st, i, j, k).x));
      }
    }
  }
  return sd;
}

// ... and its normal, at a hit: the gradient summed in the same corner order
__device__ __forceinline__ void sdf_normal(const Posed& P, const Stencil& st, float n[3]) {
  float g[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float wx = i == 0 ? fs(1.0f, st.fr[0]) : st.fr[0];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float wy = j == 0 ? fs(1.0f, st.fr[1]) : st.fr[1];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float wz = k == 0 ? fs(1.0f, st.fr[2]) : st.fr[2];
        const float w = fm(fm(wx, wy), wz);
        const float4 e = corner(P, st, i, j, k);
        g[0] = fa(g[0], fm(w, e.y));
        g[1] = fa(g[1], fm(w, e.z));
        g[2] = fa(g[2], fm(w, e.w));
      }
    }
  }
  const float den = fmaxf(sqrtf(dot3(g, g)), 1e-20f);
#pragma unroll
  for (int k = 0; k < 3; ++k) n[k] = fd(g[k], den);
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

// one collider on one massive cell (ColliderBase.resolve_soa): hit test
// first, the normal and the projection only for a hit
template <bool kSdf>
__device__ void resolve(const Posed& P, const float x[3], float v[3]) {
  const Collider& c = P.c;
  float x_mt[3], xm[3], n[3];
  to_material(P, x, x_mt, xm);
  if (kSdf && c.type == 3) {
    Stencil st;
    const float sd = sdf_value(P, xm, st);
    if (!(sd <= 0.0f)) return;
    sdf_normal(P, st, n);
  } else {
    const float sd = analytic_sd(c, xm);
    if (!(sd <= 0.0f)) return;
    analytic_normal(c, xm, n);
  }
  if (c.rotating) {
    const float nm[3] = {n[0], n[1], n[2]};
#pragma unroll
    for (int k = 0; k < 3; ++k)
      n[k] = fa(fa(fm(P.r[3 * k], nm[0]), fm(P.r[3 * k + 1], nm[1])),
                fm(P.r[3 * k + 2], nm[2]));
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

// ---------------------------------------------------------------------------
// the row plan: the cull (ops/grid_kernel.py:collider_row_mask is its plain
// twin, operation for operation)
// ---------------------------------------------------------------------------

// collider i on the row of world-box centre c and half extents h, by one
// warp (lanes split the brick minima); lane 0 writes the decision to keep
__device__ void plan_collider(const Posed& P, const float c[3], const float h[3], float dx,
                              int lane, unsigned char* keep_out, unsigned char* mask_out) {
  const Collider& C = P.c;
  float x_mt[3], xm[3];
  to_material(P, c, x_mt, xm);
  const float as = fabsf(P.s);
  const float S = fd(fa(fa(l1(c), l1(h)), l1(P.off)), as);
  const bool grid = C.type == 3;
  const float geo = grid ? fa(fabsf(C.a[1]), fabsf(C.a[2]))
                         : fa(fa(l1(C.a), l1(C.b)), C.type == 1 ? C.radius : 0.0f);
  const float margin = fa(dx, fm(fa(S, geo), kRel));
  bool keep;
  if (!grid) {
    const float rr = fm(fd(sqrtf(dot3(h, h)), as), kGrow);
    keep = !(fs(analytic_sd(C, xm), rr) > margin);
  } else {
    const float dxn = C.a[0], lo = C.a[1], hi = C.a[2];
    const int n[3] = {(int)C.b[0], (int)C.b[1], (int)C.b[2]};
    float amin[3], amax[3];
    bool out = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float e = C.rotating
                    ? fd(fa(fa(fm(fabsf(P.r[k]), h[0]), fm(fabsf(P.r[3 + k]), h[1])),
                            fm(fabsf(P.r[6 + k]), h[2])), as)
                    : fd(h[k], as);
      e = fm(e, kGrow);
      amin[k] = fs(fs(xm[k], e), margin);
      amax[k] = fa(fa(xm[k], e), margin);
      out = out || amax[k] < lo || amin[k] >= hi;
    }
    keep = !out;
    if (keep && P.bricks != nullptr) {
      int blo[3], bcnt[3], nb[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int i0 = clampi((int)floorf(fd(fmaxf(amin[k], lo), dxn)) - 1, 0, n[k] - 1);
        const int i1 = clampi((int)floorf(fd(fminf(amax[k], hi), dxn)) + 2, 0, n[k] - 1);
        nb[k] = (n[k] + (1 << kBrickShift) - 1) >> kBrickShift;
        blo[k] = i0 >> kBrickShift;
        bcnt[k] = max((i1 >> kBrickShift) - blo[k] + 1, 1);
      }
      const int total = bcnt[0] * bcnt[1] * bcnt[2];
      float vmin = INFINITY;
      for (int q = lane; q < total; q += 32) {
        const int w = q % bcnt[2], rest = q / bcnt[2];
        const int u = rest / bcnt[1], v = rest % bcnt[1];
        vmin = fminf(vmin, __ldg(&P.bricks[((size_t)(blo[0] + u) * nb[1] + (blo[1] + v)) * nb[2]
                                           + (blo[2] + w)]));
      }
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) vmin = fminf(vmin, __shfl_xor_sync(0xffffffffu, vmin, s));
      keep = !(vmin > kMinPositive);
    }
  }
  if (lane == 0) {
    *keep_out = keep ? 1 : 0;
    if (mask_out != nullptr) *mask_out = keep ? 1 : 0;
  }
}

// the plan of pool row ``row``: its block coordinates into coord[0..2], and
// per collider whether the row keeps it into keep[0..nc)
__device__ void plan_row(const Params& p, const Posed* posed, int row, int* coord,
                         unsigned char* keep, int warp, int lane) {
  if (warp >= p.num_colliders) return;
  int bx, by, bzo;
  row_coords(p, row, bx, by, bzo);
  if (warp == 0 && lane == 0) {
    coord[0] = bx;
    coord[1] = by;
    coord[2] = bzo;
  }
  const int base[3] = {bx * 4, by * 4, bzo * 32};
  const int ext[3] = {3, 3, 31};
  float c[3], h[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float lo = fm((float)base[k], p.dx), hi = fm((float)(base[k] + ext[k]), p.dx);
    c[k] = fm(fa(lo, hi), 0.5f);
    h[k] = fm(fs(hi, lo), 0.5f);
  }
  for (int i = warp; i < p.num_colliders; i += kWarps)
    plan_collider(posed[i], c, h, p.dx, lane, keep + i,
                  p.row_mask != nullptr ? p.row_mask + (size_t)row * p.num_colliders + i
                                        : nullptr);
}

// ---------------------------------------------------------------------------
// the ring
// ---------------------------------------------------------------------------

// one pool row, global -> shared by one bulk copy completing on ``bar``
__device__ __forceinline__ void load_row(const float* src, float* dst, uint64_t* bar) {
  mbar_expect_tx(bar, kRowBytes);
  bulk_load(dst, src, kRowBytes, bar);
}

// dynamic shared memory of a block with nc colliders: the mbarriers, the
// ring, the posed colliders, two row plans (block coordinates, 4 ints each;
// keep flags, one byte a collider each) and the warp maxima
__host__ __device__ constexpr size_t align_up(size_t x, size_t a) { return (x + a - 1) / a * a; }
struct Layout {
  size_t posed, coord, keep, keep_stride, max, bytes;
};
__host__ __device__ constexpr Layout layout(int nc) {
  const size_t posed = 128 + (size_t)kStages * kRowBytes;
  const size_t coord = align_up(posed + (size_t)nc * sizeof(Posed), 16);
  const size_t keep = coord + 2 * 4 * sizeof(int);
  const size_t stride = align_up((size_t)nc, 16);
  const size_t max = align_up(keep + 2 * stride, 16);
  return Layout{posed, coord, keep, stride, max, max + kWarps * sizeof(float)};
}
static_assert(layout(kMaxColliders).bytes <= 227 * 1024,
              "kMaxColliders posed colliders must fit one block's shared memory");

template <bool kSdf>
__global__ void __launch_bounds__(kThreads, kMinBlocks) grid_collider_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nc = p.num_colliders;
  const Layout L = layout(nc);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + 128);
  Posed* posed = reinterpret_cast<Posed*>(smem + L.posed);
  int* coord = reinterpret_cast<int*>(smem + L.coord);      // [2][4]
  unsigned char* keep = smem + L.keep;                     // [2][keep_stride]
  float* warp_max = reinterpret_cast<float*>(smem + L.max);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x;

  // the prologue: mbarriers, the pose of every collider, the first rows in
  // flight and the first row's plan
  const float t = *p.t_ptr;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < nc; i += kThreads) pose(p.colliders[i], p.sdf_tables, t, posed[i]);
  __syncthreads();
  if (tid == 0)
    for (int q = 0; q < kStages - 1; ++q) {
      const int row = blockIdx.x + q * G;
      if (row < p.num_rows)
        load_row(p.pool + (size_t)row * kRowFloats, ring + q * kRowFloats, &bar[q]);
    }
  plan_row(p, posed, blockIdx.x, coord, keep, warp, lane);
  __syncthreads();

  const float dt = *p.dt_ptr;
  const int cl = tid & 127;                    // the cells' lane (z8, cy, cz)
  const float gacc[3] = {p.gx, p.gy, p.gz};
  float vmax = 0.0f;
  int it = 0;
  for (int row = blockIdx.x; row < p.num_rows; row += G, ++it) {
    const int s = it % kStages;
    float* st = ring + s * kRowFloats;
    // the row kStages - 1 ahead streams into the stage the previous
    // iteration freed; the next row's plan is made while this one lands
    if (tid == 0) {
      const int ahead = row + (kStages - 1) * G;
      const int sa = (it + kStages - 1) % kStages;
      if (ahead < p.num_rows)
        load_row(p.pool + (size_t)ahead * kRowFloats, ring + sa * kRowFloats, &bar[sa]);
    }
    const int nx = (it + 1) & 1;
    if (row + G < p.num_rows)
      plan_row(p, posed, row + G, coord + 4 * nx, keep + nx * L.keep_stride, warp, lane);
    const int* co = coord + 4 * (it & 1);
    const unsigned char* kp = keep + (it & 1) * L.keep_stride;

    const int bx = co[0], by = co[1], bz = co[2] * 8 + (cl >> 4);
    const bool kaxis[3] = {!near_face(bx, p.bound_blocks, p.g),
                           !near_face(by, p.bound_blocks, p.g),
                           !near_face(bz, p.bound_blocks, p.g)};
    const float y = fm((float)(by * 4 + ((cl >> 2) & 3)), p.dx);
    const float z = fm((float)(bz * 4 + (cl & 3)), p.dx);
    mbar_wait(&bar[s], (uint32_t)(it / kStages) & 1u);

#pragma unroll 1
    for (int cx = tid >> 7; cx < 4; cx += kThreads / 128) {
      const int off = cx * 128 + cl;
      const float m = st[off];
      const bool has = m > 0.0f;
      const float minv = has ? fd(1.0f, m) : 0.0f;
      float v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float vc = fm(st[(4 + 4 * c) * 128 + off], minv);
        v[c] = fa(kaxis[c] ? vc : 0.0f, fm(gacc[c], dt));
      }
      if (has) {
        const float x[3] = {fm((float)(bx * 4 + cx), p.dx), y, z};
        for (int i = 0; i < nc; ++i)
          if (kp[i]) resolve<kSdf>(posed[i], x, v);   // uniform over the block
      }
      float vsq = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v[c] = has ? v[c] : 0.0f;
        st[(4 + 4 * c) * 128 + off] = v[c];
        vsq = c == 0 ? fm(v[c], v[c]) : fa(vsq, fm(v[c], v[c]));
      }
      if (isnan(vsq)) vsq = INFINITY;
      if (!has) vsq = 0.0f;
      vmax = fmaxf(vmax, vsq);
    }
    __syncthreads();
    // the row leaves in 16-byte stores: mass as it came, velocities
    float4* dst = reinterpret_cast<float4*>(p.pool_v + (size_t)row * kRowFloats);
#pragma unroll
    for (int q = tid; q < kRowFloats / 4; q += kThreads)
      dst[q] = reinterpret_cast<const float4*>(st)[q];
    // the stage is refilled by the async proxy next: order these accesses first
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
  }

  // block max: warp shuffle, then one warp over the warp maxima
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, s));
  if (lane == 0) warp_max[warp] = vmax;
  __syncthreads();
  if (tid < 32) {
    float w = tid < kWarps ? warp_max[tid] : 0.0f;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, s));
    if (tid == 0 && w > 0.0f)
      atomicMax(reinterpret_cast<int*>(p.max_vel_sqr), __float_as_int(w));
  }
}

template <bool kSdf>
cudaError_t collider_occupancy(int nc, int* blocks_per_sm, int* bytes) {
  *bytes = (int)layout(nc).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      grid_collider_kernel<kSdf>, cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, grid_collider_kernel<kSdf>,
                                                       kThreads, *bytes);
}

template <bool kSdf>
int launch_colliders(const Params& p, void* stream) {
  if (p.num_rows <= 0 || p.num_colliders <= 0 || p.num_colliders > kMaxColliders)
    return (int)cudaErrorInvalidValue;
  int per_sm = 0, bytes = 0, dev = 0, sms = 0;
  cudaError_t err = collider_occupancy<kSdf>(p.num_colliders, &per_sm, &bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int blocks = p.num_rows < sms * per_sm ? p.num_rows : sms * per_sm;
  grid_collider_kernel<kSdf><<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
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

// row_mask: optional u8[num_rows, num_colliders], the cull decision per
// (row, collider) (1: resolved), null on the main path
extern "C" int cm_grid_update_colliders(
    const float* pool, const int* keys, float* pool_v, float* max_vel_sqr,
    const float* dt, const void* colliders, int num_colliders, const float* t,
    unsigned char* row_mask, int num_rows, int num_keys, int g, int gzo,
    int num_oct_keys, int bound_blocks, float gx, float gy, float gz, float dx,
    void* stream) {
  const Params p{pool, keys, pool_v, max_vel_sqr, dt,
                 static_cast<const Collider*>(colliders), nullptr, t, row_mask,
                 num_colliders, num_rows, num_keys, g, gzo, num_oct_keys, bound_blocks,
                 gx, gy, gz, dx};
  return launch_colliders<false>(p, stream);
}

// sdf_tables: a device array of num_sdf pointers, one node table each
extern "C" int cm_grid_update_sdf(
    const float* pool, const int* keys, float* pool_v, float* max_vel_sqr,
    const float* dt, const void* colliders, int num_colliders,
    const void* sdf_tables, int num_sdf, const float* t, unsigned char* row_mask,
    int num_rows, int num_keys, int g, int gzo, int num_oct_keys, int bound_blocks,
    float gx, float gy, float gz, float dx, void* stream) {
  if (num_sdf <= 0 || sdf_tables == nullptr) return (int)cudaErrorInvalidValue;
  const Params p{pool, keys, pool_v, max_vel_sqr, dt,
                 static_cast<const Collider*>(colliders),
                 static_cast<const float4* const*>(sdf_tables), t, row_mask,
                 num_colliders, num_rows, num_keys, g, gzo, num_oct_keys, bound_blocks,
                 gx, gy, gz, dx};
  return launch_colliders<true>(p, stream);
}

// what the card gives a variant with num_colliders colliders: out i32[4] =
// registers, blocks per SM, dynamic shared memory in bytes, and the most
// colliders one launch takes; variant 0 K2, 1 K2-AC, 2 K2-SDF
extern "C" int cm_grid_update_info(int variant, int num_colliders, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (variant != 0 && (num_colliders < 0 || num_colliders > kMaxColliders))
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 0:
      err = cudaFuncGetAttributes(&attr, grid_update_kernel);
      if (err != cudaSuccess) return (int)err;
      out[0] = attr.numRegs;
      out[2] = 0;
      out[3] = 0;
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], grid_update_kernel,
                                                                512, 0);
    case 1:
      err = cudaFuncGetAttributes(&attr, grid_collider_kernel<false>);
      if (err != cudaSuccess) return (int)err;
      out[0] = attr.numRegs;
      out[3] = kMaxColliders;
      return (int)collider_occupancy<false>(num_colliders, &out[1], &out[2]);
    case 2:
      err = cudaFuncGetAttributes(&attr, grid_collider_kernel<true>);
      if (err != cudaSuccess) return (int)err;
      out[0] = attr.numRegs;
      out[3] = kMaxColliders;
      return (int)collider_occupancy<true>(num_colliders, &out[1], &out[2]);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
