// Fused G2P2G transfer for FixedCorotated: the Hopper kernel K1.
//
// Replaces claymore_tpu/ops/pallas_g2p2g.py:_make_kernel (launched by
// g2p2g_pallas) together with the window scatter-add and the null-row
// zeroing around it: per particle, quadratic B-spline G2P with the APIC
// moment A_rc = sum_i w_i v_i_r (x_i - x_p)_c, the FixedCorotated update
// (F <- (I + dt D^-1 A) F, polar rotation by 5 determinant-scaled Newton
// steps, contrib = V0 (2 mu (F F^T - R F^T) + lam (J-1) J I)), advection
// x += v dt, the arena range checks, and the P2G of mass and momentum
// w (m v + Q (x_i - x_p)) with Q = (A m - contrib next_dt) D^-1.
//
// Bound: on-chip work, not device memory.  A particle moves ~110 bytes
// (pos, F in and out, active, pid) but does ~1.5k flops of material math,
// 81 shared-memory arena reads in G2P and 108 shared-memory atomic adds in
// P2G; particles of one tile share few cells, so those atomics collide.
// Design: one block per tile (particle_tile particles, one home block),
// as the reference CUDA code stages its arena.  The block resolves its
// 2^3 neighbour blocks through the oct table itself (no window gather
// outside the kernel), stages their 8^3 x 3 velocities in shared memory
// (6 KB), lets each thread carry whole particles through G2P, the material
// update and P2G in registers, accumulates P2G into a shared 8^3 x 4 arena
// (8 KB) with shared atomics, and flushes that arena once per block with
// global atomicAdd, skipping zeros and the null block.  Global float
// atomics change the summation order from run to run: results agree with
// the plain version to float32 roundoff, not bit for bit.  No tensor cores:
// the TPU kernel's contractions over the particle axis are matrix products
// only because the TPU has nothing else fast; here the sums are direct.
//
// Layouts (the JAX package's): pool f32[O+1, 16, 128], rows (channel c, cx),
// lanes (z8, cy, cz), row O the null oct; a block address is
// oct_row * 8 + z8.  Particles are slot-major and component-leading:
// pos f32[3, S], F f32[9, S], active bool[S], pid i32[S], S = T * tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCells = 8;                     // arena cells per axis (2 blocks)
constexpr int kArena = kCells * kCells * kCells;
constexpr int kRowFloats = 16 * 128;

struct Params {
  const float* pool_v;
  const int* table;
  const int* bcoord;            // i32[3, T]
  const unsigned char* tvalid;  // bool[T]
  const float* pos;
  const float* F;
  const unsigned char* active;
  const int* pid;
  const float* dt_ptr;
  const float* next_dt_ptr;
  float* pos_out;
  float* F_out;
  unsigned char* active_out;
  int* pid_out;
  float* next_pool;
  int num_tiles, tile, g, gzo, num_oct_keys, null_oct;
  float dx, dx_inv, d_inv, mass, volume, two_mu, lam;
};

// polar factor by Higham's determinant-scaled Newton iteration; rows whose
// |det| reaches the epsilon floor are held (soa3.polar3)
__device__ __forceinline__ void polar3(const float a[9], float x[9]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) x[k] = a[k];
#pragma unroll 1
  for (int it = 0; it < 5; ++it) {
    float c[9];
    c[0] = x[4] * x[8] - x[5] * x[7];
    c[1] = x[5] * x[6] - x[3] * x[8];
    c[2] = x[3] * x[7] - x[4] * x[6];
    c[3] = x[2] * x[7] - x[1] * x[8];
    c[4] = x[0] * x[8] - x[2] * x[6];
    c[5] = x[1] * x[6] - x[0] * x[7];
    c[6] = x[1] * x[5] - x[2] * x[4];
    c[7] = x[2] * x[3] - x[0] * x[5];
    c[8] = x[0] * x[4] - x[1] * x[3];
    const float d = x[0] * c[0] + x[1] * c[1] + x[2] * c[2];
    const float ad = fmaxf(fabsf(d), 1e-12f);
    const float eta = expf(logf(ad) * (-1.0f / 3.0f));
    const float sgn = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
    const float ci = sgn / (eta * ad);
    if (!(ad <= 2e-12f)) {
#pragma unroll
      for (int k = 0; k < 9; ++k) x[k] = 0.5f * (eta * x[k] + ci * c[k]);
    }
  }
}

__device__ __forceinline__ float det3(const float a[9]) {
  return a[0] * (a[4] * a[8] - a[5] * a[7])
       - a[1] * (a[3] * a[8] - a[5] * a[6])
       + a[2] * (a[3] * a[7] - a[4] * a[6]);
}

// quadratic B-spline weights and moment weights w * (cell - x) per axis;
// returns false when the stencil leaves the arena (it is then clamped in)
__device__ __forceinline__ bool stencil(const Params& p, const float x[3],
                                        const int org[3], int l[3],
                                        float w[3][3], float mw[3][3]) {
  bool in_range = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float xs = x[a] * p.dx_inv;
    const int base = (int)floorf(xs + 0.5f) - 1;
    const float d = xs - (float)base;
    const int rel = base - org[a];
    in_range = in_range && rel >= 0 && rel <= kCells - 3;
    l[a] = min(max(rel, 0), kCells - 3);
    const float t0 = 1.5f - d, t1 = d - 1.0f, t2 = d - 0.5f;
    w[a][0] = 0.5f * (t0 * t0);
    w[a][1] = 0.75f - t1 * t1;
    w[a][2] = 0.5f * (t2 * t2);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      mw[a][i] = w[a][i] * ((float)(org[a] + l[a] + i) * p.dx - x[a]);
  }
  return in_range;
}

__global__ void __launch_bounds__(kThreads)
g2p2g_fixed_corotated_kernel(const Params p) {
  __shared__ float varena[3 * kArena];
  __shared__ float oarena[4 * kArena];
  __shared__ int nb[8];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t S = (size_t)p.num_tiles * p.tile;
  const size_t s0 = (size_t)t * p.tile;

  // the null row absorbs nothing from this kernel (null-block flushes are
  // skipped), so one block clears it without racing anyone
  if (t == 0) {
    float* nrow = p.next_pool + (size_t)p.null_oct * kRowFloats;
    for (int i = tid; i < kRowFloats; i += kThreads) nrow[i] = 0.0f;
  }

  if (!p.tvalid[t]) {
    // dead tile: state passes through, nothing is active
    for (int q = tid; q < p.tile; q += kThreads) {
      const size_t s = s0 + q;
#pragma unroll
      for (int c = 0; c < 3; ++c) p.pos_out[c * S + s] = p.pos[c * S + s];
#pragma unroll
      for (int k = 0; k < 9; ++k) p.F_out[k * S + s] = p.F[k * S + s];
      p.active_out[s] = 0;
      p.pid_out[s] = (int)S;
    }
    return;
  }

  const int bc[3] = {p.bcoord[t], p.bcoord[p.num_tiles + t],
                     p.bcoord[2 * p.num_tiles + t]};
  if (tid < 8) {
    const int cx = bc[0] + (tid >> 2), cy = bc[1] + ((tid >> 1) & 1),
              cz = bc[2] + (tid & 1);
    const bool valid = cx >= 0 && cx < p.g && cy >= 0 && cy < p.g &&
                       cz >= 0 && cz < p.g;
    const int okey = valid ? (cx * p.g + cy) * p.gzo + (cz >> 3) : p.num_oct_keys;
    const int oslot = p.table[okey];
    nb[tid] = oslot == p.null_oct ? p.null_oct * 8 : oslot * 8 + (cz & 7);
  }
  for (int i = tid; i < 4 * kArena; i += kThreads) oarena[i] = 0.0f;
  __syncthreads();

  // stage the 8^3 velocity arena (pool rows 4..15); inactive neighbours
  // read the null row, as the plain version does
  for (int i = tid; i < 3 * kArena; i += kThreads) {
    const int r = i / kArena, cell = i % kArena;
    const int x = cell >> 6, y = (cell >> 3) & 7, z = cell & 7;
    const int br = nb[(x >> 2) * 4 + (y >> 2) * 2 + (z >> 2)];
    varena[i] = p.pool_v[((size_t)(br >> 3) * 16 + 4 + r * 4 + (x & 3)) * 128
                         + (br & 7) * 16 + (y & 3) * 4 + (z & 3)];
  }
  __syncthreads();

  const float dt = *p.dt_ptr;
  const float next_dt = *p.next_dt_ptr;
  const int org[3] = {bc[0] * 4, bc[1] * 4, bc[2] * 4};

  for (int q = tid; q < p.tile; q += kThreads) {
    const size_t s = s0 + q;
    float x[3] = {p.pos[s], p.pos[S + s], p.pos[2 * S + s]};

    // ---- G2P: velocity and APIC moment, A[r*3+c] ----
    int l[3];
    float w[3][3], mw[3][3];
    const bool in_pre = stencil(p, x, org, l, w, mw);
    float v[3] = {0.0f, 0.0f, 0.0f};
    float A[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) A[k] = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float wxy = w[0][i] * w[1][j];
        const float mxwy = mw[0][i] * w[1][j];
        const float wxmy = w[0][i] * mw[1][j];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float W = wxy * w[2][k];
          const float Wx = mxwy * w[2][k];
          const float Wy = wxmy * w[2][k];
          const float Wz = wxy * mw[2][k];
          const int idx = (l[0] + i) * 64 + (l[1] + j) * 8 + (l[2] + k);
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const float vr = varena[r * kArena + idx];
            v[r] += W * vr;
            A[r * 3 + 0] += Wx * vr;
            A[r * 3 + 1] += Wy * vr;
            A[r * 3 + 2] += Wz * vr;
          }
        }
      }
    }

    // ---- FixedCorotated: F <- (I + dt D^-1 A) F, then the stress ----
    float Fo[9], Fn[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) Fo[k] = p.F[k * S + s];
    const float sc = dt * p.d_inv;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float c0 = A[r * 3 + 0] * sc + (r == 0 ? 1.0f : 0.0f);
      const float c1 = A[r * 3 + 1] * sc + (r == 1 ? 1.0f : 0.0f);
      const float c2 = A[r * 3 + 2] * sc + (r == 2 ? 1.0f : 0.0f);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        Fn[r * 3 + c] = c0 * Fo[c] + c1 * Fo[3 + c] + c2 * Fo[6 + c];
    }
    float R[9];
    polar3(Fn, R);
    const float J = det3(Fn);
    if (J < 0.0f) {
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = -R[k];
    }
    const float lam_j = p.lam * (J - 1.0f) * J;
    float contrib[9];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float ff = Fn[r * 3] * Fn[c * 3] + Fn[r * 3 + 1] * Fn[c * 3 + 1]
                       + Fn[r * 3 + 2] * Fn[c * 3 + 2];
        const float rf = R[r * 3] * Fn[c * 3] + R[r * 3 + 1] * Fn[c * 3 + 1]
                       + R[r * 3 + 2] * Fn[c * 3 + 2];
        float dev = p.two_mu * (ff - rf);
        if (r == c) dev += lam_j;
        contrib[r * 3 + c] = dev * p.volume;
      }
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) p.F_out[k * S + s] = Fn[k];

    // ---- advection and the post-advection range check ----
#pragma unroll
    for (int a = 0; a < 3; ++a) x[a] = x[a] + v[a] * dt;
    p.pos_out[s] = x[0];
    p.pos_out[S + s] = x[1];
    p.pos_out[2 * S + s] = x[2];
    const bool in_post = stencil(p, x, org, l, w, mw);
    const bool ok = p.active[s] && in_pre && in_post;
    p.active_out[s] = ok ? 1 : 0;
    p.pid_out[s] = ok ? p.pid[s] : (int)S;
    if (!ok) continue;

    // ---- P2G: mass and momentum w (m v + Q (x_i - x_p)) ----
    float Q[9];
#pragma unroll
    for (int k = 0; k < 9; ++k)
      Q[k] = (A[k] * p.mass - contrib[k] * next_dt) * p.d_inv;
    const float mv[3] = {v[0] * p.mass, v[1] * p.mass, v[2] * p.mass};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float wxy = w[0][i] * w[1][j];
        const float mxwy = mw[0][i] * w[1][j];
        const float wxmy = w[0][i] * mw[1][j];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float W = wxy * w[2][k];
          const float Wx = mxwy * w[2][k];
          const float Wy = wxmy * w[2][k];
          const float Wz = wxy * mw[2][k];
          const int idx = (l[0] + i) * 64 + (l[1] + j) * 8 + (l[2] + k);
          atomicAdd(&oarena[idx], W * p.mass);
#pragma unroll
          for (int r = 0; r < 3; ++r)
            atomicAdd(&oarena[(1 + r) * kArena + idx],
                      W * mv[r] + Wx * Q[r * 3] + Wy * Q[r * 3 + 1]
                      + Wz * Q[r * 3 + 2]);
        }
      }
    }
  }
  __syncthreads();

  // ---- flush the 8^3 x 4 arena into the next pool ----
  for (int i = tid; i < 4 * kArena; i += kThreads) {
    const float val = oarena[i];
    if (val == 0.0f) continue;
    const int ch = i / kArena, cell = i % kArena;
    const int x = cell >> 6, y = (cell >> 3) & 7, z = cell & 7;
    const int br = nb[(x >> 2) * 4 + (y >> 2) * 2 + (z >> 2)];
    if ((br >> 3) == p.null_oct) continue;
    atomicAdd(&p.next_pool[((size_t)(br >> 3) * 16 + ch * 4 + (x & 3)) * 128
                           + (br & 7) * 16 + (y & 3) * 4 + (z & 3)], val);
  }
}

}  // namespace

extern "C" int cm_g2p2g_fixed_corotated(
    const float* pool_v, const int* table, const int* bcoord,
    const unsigned char* tvalid, const float* pos, const float* F,
    const unsigned char* active, const int* pid, const float* dt,
    const float* next_dt, float* pos_out, float* F_out,
    unsigned char* active_out, int* pid_out, float* next_pool,
    int num_tiles, int tile, int g, int gzo, int num_oct_keys, int null_oct,
    float dx, float dx_inv, float d_inv, float mass, float volume,
    float two_mu, float lam, void* stream) {
  if (num_tiles <= 0 || tile <= 0) return (int)cudaErrorInvalidValue;
  Params p{pool_v, table, bcoord, tvalid, pos, F, active, pid, dt, next_dt,
           pos_out, F_out, active_out, pid_out, next_pool,
           num_tiles, tile, g, gzo, num_oct_keys, null_oct,
           dx, dx_inv, d_inv, mass, volume, two_mu, lam};
  g2p2g_fixed_corotated_kernel<<<num_tiles, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
