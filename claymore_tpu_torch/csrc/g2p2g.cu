// Fused G2P2G transfer: the Hopper kernel K1, one variant per material.
//
// Replaces claymore_tpu/ops/pallas_g2p2g.py:_make_kernel (launched by
// g2p2g_pallas, built there once per material with its field layout,
// :564-594) together with the window scatter-add and the null-row zeroing
// around it: per particle, quadratic B-spline G2P with the APIC moment
// A_rc = sum_i w_i v_i_r (x_i - x_p)_c, the material update
// (material.update, models/materials.py), advection x += v dt, the arena
// range checks, and the P2G of mass and momentum w (m v + Q (x_i - x_p))
// with Q = (A m - contrib next_dt) D^-1.
//
// The kernel body is a template on a material functor that carries the
// field layout and the update:
//   FixedCorotated  F [9,S]             polar rotation by 5 Newton steps
//   JFluid          J [S]               J update, clamp, Tait pressure, viscosity
//   Sand            F [9,S], logJp [S]  svd3, Drucker-Prager return map, Hencky
//   NACC            F [9,S], logJp [S]  svd3, Cam-Clay projection, hardening
// svd3 is the JAX package's (ops/soa3.py:210): 4 cyclic Jacobi sweeps on
// A^T A, compare-swap sort with a strict >, Givens QR of A V, sign fix-up;
// at an exact diagonal tie the Jacobi rotation is the 45-degree one, where
// the JAX package's sign(0) = 0 would skip it (see soa3._jacobi_cs).
// The arithmetic follows the plain PyTorch version term by term; it is
// built without --use_fast_math, so logf/expf/powf are the accurate ones.
//
// Bound: on-chip work, not device memory.  A particle moves ~110 bytes
// (pos, fields in and out, active, pid) but does ~1.5k flops of material
// math (several thousand with svd3), 81 shared-memory arena reads in G2P
// and 108 shared-memory atomic adds in P2G; particles of one tile share few
// cells, so those atomics collide.  Design: one block per tile
// (particle_tile particles, one home block), as the reference CUDA code
// stages its arena.  The block resolves its 2^3 neighbour blocks through
// the oct table itself (no window gather outside the kernel), stages their
// 8^3 x 3 velocities in shared memory (6 KB), lets each thread carry whole
// particles through G2P, the material update and P2G in registers,
// accumulates P2G into a shared 8^3 x 4 arena (8 KB) with shared atomics,
// and flushes that arena once per block with global atomicAdd, skipping
// zeros and the null block.  Global float atomics change the summation
// order from run to run: results agree with the plain version to float32
// roundoff, not bit for bit.  No tensor cores: the TPU kernel's
// contractions over the particle axis are matrix products only because
// the TPU has nothing else fast; here the sums are direct.
//
// Layouts (the JAX package's): pool f32[O+1, 16, 128], rows (channel c, cx),
// lanes (z8, cy, cz), row O the null oct; a block address is
// oct_row * 8 + z8.  Particles are slot-major and component-leading:
// pos f32[3, S], F f32[9, S], J or logJp f32[S], active bool[S], pid i32[S],
// S = T * tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCells = 8;                     // arena cells per axis (2 blocks)
constexpr int kArena = kCells * kCells * kCells;
constexpr int kRowFloats = 16 * 128;
constexpr int kMaxParams = 16;

struct Params {
  const float* pool_v;
  const int* table;
  const int* bcoord;            // i32[3, T]
  const unsigned char* tvalid;  // bool[T]
  const float* pos;
  const float* F;               // f32[9, S] or null
  const float* aux;             // f32[S] (J or logJp) or null
  const unsigned char* active;
  const int* pid;
  const float* dt_ptr;
  const float* next_dt_ptr;
  float* pos_out;
  float* F_out;
  float* aux_out;
  unsigned char* active_out;
  int* pid_out;
  float* next_pool;
  int num_tiles, tile, g, gzo, num_oct_keys, null_oct;
  float dx, dx_inv, d_inv, mass;
  float mp[kMaxParams];         // the material's constants (ops/g2p2g_kernel.py)
};

// ---------------------------------------------------------------------------
// 3x3 helpers, row-major a[r*3+c] (ops/soa3.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float det3(const float a[9]) {
  return a[0] * (a[4] * a[8] - a[5] * a[7])
       - a[1] * (a[3] * a[8] - a[5] * a[6])
       + a[2] * (a[3] * a[7] - a[4] * a[6]);
}

__device__ __forceinline__ void matmul3(const float a[9], const float b[9],
                                        float c[9]) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      c[r * 3 + k] = a[r * 3] * b[k] + a[r * 3 + 1] * b[3 + k]
                   + a[r * 3 + 2] * b[6 + k];
}

// a @ b^T
__device__ __forceinline__ void matmul_bt(const float a[9], const float b[9],
                                          float c[9]) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      c[r * 3 + k] = a[r * 3] * b[k * 3] + a[r * 3 + 1] * b[k * 3 + 1]
                   + a[r * 3 + 2] * b[k * 3 + 2];
}

// u @ diag(s) @ v^T
__device__ __forceinline__ void u_diag_vt(const float u[9], const float s[3],
                                          const float v[9], float out[9]) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[r * 3 + c] = u[r * 3] * s[0] * v[c * 3]
                     + u[r * 3 + 1] * s[1] * v[c * 3 + 1]
                     + u[r * 3 + 2] * s[2] * v[c * 3 + 2];
}

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

__device__ __forceinline__ void jacobi_cs(float app, float aqq, float apq,
                                          float& c, float& s) {
  const bool small = fabsf(apq) < 1e-12f;
  const float tau = (aqq - app) / (2.0f * (small ? 1.0f : apq));
  // +1 at tau = 0, the 45-degree rotation (soa3._jacobi_cs)
  const float sg = tau >= 0.0f ? 1.0f : -1.0f;
  float t = sg / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  t = small ? 0.0f : t;
  c = rsqrtf(1.0f + t * t);
  s = t * c;
}

__device__ __forceinline__ void givens_cs(float a, float b, float& c, float& s) {
  const float r = sqrtf(a * a + b * b);
  const bool good = r > 1e-12f;
  const float inv = good ? 1.0f / fmaxf(r, 1e-12f) : 0.0f;
  c = good ? a * inv : 1.0f;
  s = good ? -b * inv : 0.0f;
}

__device__ __forceinline__ void rot_cols(float v[9], int p, int q, float c,
                                         float s) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float vp = v[3 * r + p], vq = v[3 * r + q];
    v[3 * r + p] = c * vp - s * vq;
    v[3 * r + q] = s * vp + c * vq;
  }
}

__device__ __forceinline__ void rot_rows(float m[9], int p, int q, float c,
                                         float s) {
#pragma unroll
  for (int col = 0; col < 3; ++col) {
    const float mp = m[3 * p + col], mq = m[3 * q + col];
    m[3 * p + col] = c * mp - s * mq;
    m[3 * q + col] = s * mp + c * mq;
  }
}

__device__ __forceinline__ void cswap(float& e_hi, float& e_lo, float v[9],
                                      int p, int q) {
  if (e_lo > e_hi) {
    const float e = e_hi;
    e_hi = e_lo;
    e_lo = e;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float vp = v[3 * r + p];
      v[3 * r + p] = v[3 * r + q];
      v[3 * r + q] = -vp;
    }
  }
}

// signed SVD: U, V proper rotations, s[2] carries sign(det a) (soa3.svd3)
__device__ void svd3(const float a[9], float u[9], float s[3], float v[9]) {
  float b00 = a[0] * a[0] + a[3] * a[3] + a[6] * a[6];
  float b11 = a[1] * a[1] + a[4] * a[4] + a[7] * a[7];
  float b22 = a[2] * a[2] + a[5] * a[5] + a[8] * a[8];
  float b01 = a[0] * a[1] + a[3] * a[4] + a[6] * a[7];
  float b02 = a[0] * a[2] + a[3] * a[5] + a[6] * a[8];
  float b12 = a[1] * a[2] + a[4] * a[5] + a[7] * a[8];
#pragma unroll
  for (int k = 0; k < 9; ++k) v[k] = (k % 4 == 0) ? 1.0f : 0.0f;
#pragma unroll 1
  for (int sweep = 0; sweep < 4; ++sweep) {
    float c, sn, n0, n1;
    jacobi_cs(b00, b11, b01, c, sn);
    n0 = c * c * b00 - 2.0f * c * sn * b01 + sn * sn * b11;
    n1 = sn * sn * b00 + 2.0f * c * sn * b01 + c * c * b11;
    b00 = n0; b11 = n1; b01 = 0.0f;
    n0 = c * b02 - sn * b12; n1 = sn * b02 + c * b12;
    b02 = n0; b12 = n1;
    rot_cols(v, 0, 1, c, sn);
    jacobi_cs(b00, b22, b02, c, sn);
    n0 = c * c * b00 - 2.0f * c * sn * b02 + sn * sn * b22;
    n1 = sn * sn * b00 + 2.0f * c * sn * b02 + c * c * b22;
    b00 = n0; b22 = n1; b02 = 0.0f;
    n0 = c * b01 - sn * b12; n1 = sn * b01 + c * b12;
    b01 = n0; b12 = n1;
    rot_cols(v, 0, 2, c, sn);
    jacobi_cs(b11, b22, b12, c, sn);
    n0 = c * c * b11 - 2.0f * c * sn * b12 + sn * sn * b22;
    n1 = sn * sn * b11 + 2.0f * c * sn * b12 + c * c * b22;
    b11 = n0; b22 = n1; b12 = 0.0f;
    n0 = c * b01 - sn * b02; n1 = sn * b01 + c * b02;
    b01 = n0; b02 = n1;
    rot_cols(v, 1, 2, c, sn);
  }
  cswap(b00, b11, v, 0, 1);
  cswap(b00, b22, v, 0, 2);
  cswap(b11, b22, v, 1, 2);

  // Givens QR of A V: U R = A V with R ~ diag(sigma)
  float r[9], g[9];
  matmul3(a, v, r);
#pragma unroll
  for (int k = 0; k < 9; ++k) g[k] = (k % 4 == 0) ? 1.0f : 0.0f;
  const int pi[3] = {1, 2, 2}, pj[3] = {0, 0, 1};
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int i = pi[e], j = pj[e];
    float c, sn;
    givens_cs(r[3 * j + j], r[3 * i + j], c, sn);
    rot_rows(r, j, i, c, sn);
    rot_rows(g, j, i, c, sn);
  }
#pragma unroll
  for (int rr = 0; rr < 3; ++rr)
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) u[rr * 3 + cc] = g[cc * 3 + rr];
  s[0] = r[0]; s[1] = r[4]; s[2] = r[8];
  // signs of the two largest sigmas into U's columns, pairwise with the
  // last column so det(U) stays +1
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float sign = s[k] < 0.0f ? -1.0f : 1.0f;
#pragma unroll
    for (int rr = 0; rr < 3; ++rr) {
      u[3 * rr + k] *= sign;
      u[3 * rr + 2] *= sign;
    }
    s[k] *= sign;
    s[2] *= sign;
  }
}

// F <- (I + dt D^-1 A) F
__device__ __forceinline__ void deformation_update(const Params& p,
                                                   const float A[9], float dt,
                                                   size_t s, size_t S,
                                                   float Fn[9]) {
  float Fo[9];
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
}

__device__ __forceinline__ void store_f(const Params& p, const float f[9],
                                        size_t s, size_t S) {
#pragma unroll
  for (int k = 0; k < 9; ++k) p.F_out[k * S + s] = f[k];
}

// ---------------------------------------------------------------------------
// materials: field layout + update(params, A, dt, slot) -> contrib
// ---------------------------------------------------------------------------

// mp: 2 mu, lam, volume
struct FixedCorotated {
  static constexpr bool kF = true, kAux = false;
  __device__ static void update(const Params& p, const float A[9], float dt,
                                size_t s, size_t S, float contrib[9]) {
    float Fn[9], R[9];
    deformation_update(p, A, dt, s, S, Fn);
    polar3(Fn, R);
    const float J = det3(Fn);
    if (J < 0.0f) {
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = -R[k];
    }
    const float two_mu = p.mp[0], lam = p.mp[1], volume = p.mp[2];
    const float lam_j = lam * (J - 1.0f) * J;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float ff = Fn[r * 3] * Fn[c * 3] + Fn[r * 3 + 1] * Fn[c * 3 + 1]
                       + Fn[r * 3 + 2] * Fn[c * 3 + 2];
        const float rf = R[r * 3] * Fn[c * 3] + R[r * 3 + 1] * Fn[c * 3 + 1]
                       + R[r * 3 + 2] * Fn[c * 3 + 2];
        float dev = two_mu * (ff - rf);
        if (r == c) dev += lam_j;
        contrib[r * 3 + c] = dev * volume;
      }
    }
    store_f(p, Fn, s, S);
  }
};

// mp: bulk, -gamma, viscosity, volume
struct JFluid {
  static constexpr bool kF = false, kAux = true;
  __device__ static void update(const Params& p, const float A[9], float dt,
                                size_t s, size_t S, float contrib[9]) {
    float J = p.aux[s];
    const float tr = A[0] + A[4] + A[8];
    J = J + tr * (dt * p.d_inv) * J;
    J = isnan(J) ? J : fmaxf(J, 0.1f);
    const float voln = J * p.mp[3];
    const float pressure = p.mp[0] * (powf(J, p.mp[1]) - 1.0f);
    const float vd = p.d_inv * p.mp[2];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float sym = (A[r * 3 + c] + A[c * 3 + r]) * vd;
        if (r == c) sym = sym + (-pressure);
        contrib[r * 3 + c] = sym * voln;
      }
    p.aux_out[s] = J;
  }
};

// mp: cohesion, (3 lam + 2 mu)/(2 mu), yield surface, exp(cohesion), beta,
//     volume correction (0/1), 2 mu, lam, volume
struct Sand {
  static constexpr bool kF = true, kAux = true;
  __device__ static void update(const Params& p, const float A[9], float dt,
                                size_t s, size_t S, float contrib[9]) {
    const float cohesion = p.mp[0], c_dg = p.mp[1], ys = p.mp[2];
    const float s_tip = p.mp[3], beta = p.mp[4];
    const float two_mu = p.mp[6], lam = p.mp[7], volume = p.mp[8];
    float f[9], u[9], v[9], sv[3];
    deformation_update(p, A, dt, s, S, f);
    const float log_jp = p.aux[s];
    svd3(f, u, sv, v);

    float eps[3], eps_hat[3], new_s[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) eps[k] = logf(fmaxf(fabsf(sv[k]), 1e-4f)) - cohesion;
    const float sum_eps = eps[0] + eps[1] + eps[2];
    const float trace_eps = sum_eps + log_jp;
    const float third = trace_eps / 3.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) eps_hat[k] = eps[k] - third;
    const float hat_norm = sqrtf(eps_hat[0] * eps_hat[0] + eps_hat[1] * eps_hat[1]
                                 + eps_hat[2] * eps_hat[2]);
    const float safe_norm = fmaxf(hat_norm, 1e-20f);
    const bool tip = trace_eps >= 0.0f;
    const float delta_gamma = hat_norm + c_dg * trace_eps * ys;
    const bool inside = delta_gamma <= 0.0f;
    const float coef = delta_gamma / safe_norm;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float h = inside ? eps[k] + cohesion
                             : eps[k] - coef * eps_hat[k] + cohesion;
      new_s[k] = tip ? s_tip : expf(h);
    }
    float new_log_jp;
    if (p.mp[5] != 0.0f)
      new_log_jp = tip ? beta * sum_eps + log_jp : 0.0f;
    else
      new_log_jp = tip ? log_jp : 0.0f;

    u_diag_vt(u, new_s, v, f);
    float log_s[3], ph[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) log_s[k] = logf(new_s[k]);
    const float trace_log = log_s[0] + log_s[1] + log_s[2];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      ph[k] = (two_mu * log_s[k] + lam * trace_log) / new_s[k];
    float P[9], pf[9];
    u_diag_vt(u, ph, v, P);
    matmul_bt(P, f, pf);
#pragma unroll
    for (int k = 0; k < 9; ++k) contrib[k] = pf[k] * volume;
    store_f(p, f, s, S);
    p.aux_out[s] = new_log_jp;
  }
};

// mp: mu, bm, xi, -beta, msqr, volume, hardening (0/1), 1.5 (1 + 2 beta),
//     1 - beta, 1 + 2 beta, -bm/2, bm/2
struct NACC {
  static constexpr bool kF = true, kAux = true;
  __device__ static void update(const Params& p, const float A[9], float dt,
                                size_t s, size_t S, float contrib[9]) {
    const float mu = p.mp[0], bm = p.mp[1], xi = p.mp[2], neg_beta = p.mp[3];
    const float msqr = p.mp[4], volume = p.mp[5];
    const float ys_half = p.mp[7], one_m_beta = p.mp[8], one_p_2beta = p.mp[9];
    const float neg_bm_half = p.mp[10], bm_half = p.mp[11];
    float f[9], u[9], v[9], sv[3];
    deformation_update(p, A, dt, s, S, f);
    const float log_jp = p.aux[s];
    svd3(f, u, sv, v);
    const float s0 = sv[0], s1 = sv[1], s2 = sv[2];

    // sinh spelled through exp, as the JAX package does
    const float xh = xi * fmaxf(-log_jp, 0.0f);
    const float p0 = bm * (1e-5f + 0.5f * (expf(xh) - expf(-xh)));
    const float p_min = neg_beta * p0;
    const float je = s0 * s1 * s2;
    const float b0 = s0 * s0, b1 = s1 * s1, b2 = s2 * s2;
    const float tr3 = (b0 + b1 + b2) / 3.0f;
    const float jmu = mu * powf(je, -2.0f / 3.0f);
    const float sh[3] = {jmu * (b0 - tr3), jmu * (b1 - tr3), jmu * (b2 - tr3)};
    const float p_trial = neg_bm_half * (je - 1.0f / je) * je;
    const float yp_half = msqr * (p_trial - p_min) * (p_trial - p0);
    const float sh_sqr = sh[0] * sh[0] + sh[1] * sh[1] + sh[2] * sh[2];
    const float y = ys_half * sh_sqr + yp_half;

    const bool hit_max = p_trial > p0;
    const bool hit_min = p_trial < p_min;
    const bool hit = hit_max || hit_min;
    const float p_tip = hit_max ? p0 : p_min;
    const float je_tip = sqrtf(fmaxf(-2.0f * p_tip / bm + 1.0f, 1e-12f));
    const float s_tip = powf(je_tip, 1.0f / 3.0f);
    const bool outside = !hit && y >= 1e-4f;
    const float safe_sh = fmaxf(sh_sqr, 1e-20f);
    const float b_coeff = powf(je, 2.0f / 3.0f) / mu
                          * sqrtf(fmaxf(-yp_half, 0.0f) / ys_half)
                          / sqrtf(safe_sh);
    float new_s[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float proj = sqrtf(fmaxf(sh[k] * b_coeff + tr3, 1e-12f));
      new_s[k] = hit ? s_tip : (outside ? proj : sv[k]);
    }

    float new_log_jp = log_jp;
    if (p.mp[6] != 0.0f) {
      const float tip_update = logf(fmaxf(je, 1e-12f) / fmaxf(je_tip, 1e-12f));
      if (hit) new_log_jp = log_jp + tip_update;
      const bool harden3 = outside && p0 > 1e-4f && p_trial < p0 - 1e-4f
                           && p_trial > 1e-4f + p_min;
      const float p_center = one_m_beta * p0 / 2.0f;
      const float q_trial = sqrtf(1.5f * safe_sh);
      float dir0 = p_center - p_trial, dir1 = -q_trial;
      const float dn = sqrtf(fmaxf(dir0 * dir0 + dir1 * dir1, 1e-20f));
      dir0 = dir0 / dn;
      dir1 = dir1 / dn;
      const float cc = msqr * (p_center - p_min) * (p_center - p0);
      const float bb = msqr * dir0 * (2.0f * p_center - p0 - p_min);
      const float aa = msqr * dir0 * dir0 + one_p_2beta * dir1 * dir1;
      const float disc = sqrtf(fmaxf(bb * bb - 4.0f * aa * cc, 0.0f));
      const float safe_aa = fabsf(aa) < 1e-20f ? 1e-20f : aa;
      const float l1 = (-bb + disc) / (2.0f * safe_aa);
      const float l2 = (-bb - disc) / (2.0f * safe_aa);
      const float p1 = p_center + l1 * dir0;
      const float p2 = p_center + l2 * dir0;
      const float p_fake = (p_trial - p_center) * (p1 - p_center) > 0.0f ? p1 : p2;
      const float je_fake = sqrtf(fabsf(-2.0f * p_fake / bm + 1.0f));
      const float h_update = logf(fmaxf(je, 1e-12f) / fmaxf(je_fake, 1e-12f));
      if (harden3 && je_fake > 1e-4f) new_log_jp = new_log_jp + h_update;
    }

    u_diag_vt(u, new_s, v, f);
    const float J = new_s[0] * new_s[1] * new_s[2];
    float b[9];
    matmul_bt(f, f, b);
    const float shift = -(b[0] + b[4] + b[8]) / 3.0f;
    const float dev_coeff = mu * powf(fmaxf(J, 1e-12f), -2.0f / 3.0f);
    const float i_coeff = bm_half * ((J * J - 1.0f) * 0.5f - logf(fmaxf(J, 1e-12f)));
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float bd = b[r * 3 + c];
        if (r == c) bd = bd + shift;
        float x = bd * dev_coeff;
        if (r == c) x = x + i_coeff;
        contrib[r * 3 + c] = x * volume;
      }
    store_f(p, f, s, S);
    p.aux_out[s] = new_log_jp;
  }
};

// ---------------------------------------------------------------------------
// the transfer
// ---------------------------------------------------------------------------

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

template <class M>
__global__ void __launch_bounds__(kThreads) g2p2g_kernel(const Params p) {
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
    // dead tile: state and fields pass through, nothing is active
    for (int q = tid; q < p.tile; q += kThreads) {
      const size_t s = s0 + q;
#pragma unroll
      for (int c = 0; c < 3; ++c) p.pos_out[c * S + s] = p.pos[c * S + s];
      if (M::kF) {
#pragma unroll
        for (int k = 0; k < 9; ++k) p.F_out[k * S + s] = p.F[k * S + s];
      }
      if (M::kAux) p.aux_out[s] = p.aux[s];
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

    // ---- the material: new fields and the stress contribution ----
    float contrib[9];
    M::update(p, A, dt, s, S, contrib);

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

template <class M>
int launch(const float* pool_v, const int* table, const int* bcoord,
           const unsigned char* tvalid, const float* pos, const float* F,
           const float* aux, const unsigned char* active, const int* pid,
           const float* dt, const float* next_dt, float* pos_out,
           float* F_out, float* aux_out, unsigned char* active_out,
           int* pid_out, float* next_pool, int num_tiles, int tile, int g,
           int gzo, int num_oct_keys, int null_oct, float dx, float dx_inv,
           float d_inv, float mass, const float* mp, int num_mp,
           void* stream) {
  if (num_tiles <= 0 || tile <= 0 || num_mp < 0 || num_mp > kMaxParams)
    return (int)cudaErrorInvalidValue;
  if ((M::kF && (F == nullptr || F_out == nullptr)) ||
      (M::kAux && (aux == nullptr || aux_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p{pool_v, table, bcoord, tvalid, pos, F, aux, active, pid, dt,
           next_dt, pos_out, F_out, aux_out, active_out, pid_out, next_pool,
           num_tiles, tile, g, gzo, num_oct_keys, null_oct,
           dx, dx_inv, d_inv, mass, {}};
  for (int i = 0; i < num_mp; ++i) p.mp[i] = mp[i];
  g2p2g_kernel<M><<<num_tiles, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// one C entry per material, all with the same arguments; F/aux and their
// outputs are null where the material has no such field
#define CM_G2P2G_ENTRY(NAME, MAT)                                              \
  extern "C" int NAME(                                                         \
      const float* pool_v, const int* table, const int* bcoord,                \
      const unsigned char* tvalid, const float* pos, const float* F,           \
      const float* aux, const unsigned char* active, const int* pid,           \
      const float* dt, const float* next_dt, float* pos_out, float* F_out,     \
      float* aux_out, unsigned char* active_out, int* pid_out,                 \
      float* next_pool, int num_tiles, int tile, int g, int gzo,               \
      int num_oct_keys, int null_oct, float dx, float dx_inv, float d_inv,     \
      float mass, const float* mp, int num_mp, void* stream) {                 \
    return launch<MAT>(pool_v, table, bcoord, tvalid, pos, F, aux, active,     \
                       pid, dt, next_dt, pos_out, F_out, aux_out, active_out,  \
                       pid_out, next_pool, num_tiles, tile, g, gzo,            \
                       num_oct_keys, null_oct, dx, dx_inv, d_inv, mass, mp,    \
                       num_mp, stream);                                        \
  }

CM_G2P2G_ENTRY(cm_g2p2g_fixed_corotated, FixedCorotated)
CM_G2P2G_ENTRY(cm_g2p2g_jfluid, JFluid)
CM_G2P2G_ENTRY(cm_g2p2g_sand, Sand)
CM_G2P2G_ENTRY(cm_g2p2g_nacc, NACC)
