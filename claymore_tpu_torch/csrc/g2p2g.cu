// Fused G2P2G transfer: the Hopper kernel K1, one variant per material.
//
// Replaces claymore_tpu/ops/pallas_g2p2g.py:_make_kernel (launched by
// g2p2g_pallas, built there once per material with its field layout,
// :564-594) together with the window scatter-add and the null-row zeroing
// around it: per particle, quadratic B-spline G2P with the APIC moment
// A_rc = sum_i w_i v_i_r (x_i - x_p)_c, the material update
// (material.update, models/materials.py), advection x += v dt, the arena
// range checks, and the P2G of mass and momentum w (m v + Q (x_i - x_p))
// with Q = (A m - contrib next_dt) D^-1.  It also returns the drift margin
// of core/partition.py:arena_margin on its own output, so the substep needs
// no second pass over the particles.
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
// What bounds it on an H100.  utils/bounds.py:g2p2g_bound counts the
// function's work: every slot's state read and written once and the arena
// rows once (~106 bytes a slot) against ~2.4k operations per active particle (several
// thousand with svd3); at sphere25m that is 1.35 ms of bytes against 0.9 ms
// of operations, so the bound is set by bytes.  The kernel does not run at
// either rate.  What held the first design (one 256-thread block per tile,
// 127 registers, 2 blocks per SM) at 7.5% of that bound were latencies:
// (1) its P2G, 108 shared float atomicAdds per particle, each of which
// sm_90a compiles to a load and an ATOMS.CAST.SPIN compare-and-swap loop;
// particles arrive in home-block order, so the lanes of a warp shared cells
// and went round the loop again for each (14-36 ms for one state by slot
// order alone); (2) the particle stream: 4-byte copies at two blocks per SM
// kept few bytes in flight (3.9 ms with every tile dead, a third of the
// bytes rate); (3) nothing overlapped a tile's loads with its math.
//
// The design:
//  * Persistent blocks (SMs x the occupancy the runtime reports) walk the
//    tiles.  A tile's particle columns are contiguous runs of `tile` words
//    (component-leading, slot-major), so one thread moves them into shared
//    memory with 1-D bulk asynchronous copies (cp.async.bulk, completion on
//    an mbarrier) into a 2-stage ring: tile i+1 streams in while tile i
//    computes.  The 8 neighbour blocks' velocity rows of tile i+1 come in
//    with 16-byte cp.async behind them.  Outputs are written back in place
//    into the stage and leave as 16-byte vector stores.
//  * Only each tile's occupied prefix takes that pipe: slots [0, L) with L
//    one past its last active slot rounded up to 16 (0 for a tile that is
//    not valid).  The capacity the rebucket sizes (exact_tiles' slack, each
//    oct padded to group_tiles) holds many dead tiles and overflow tiles of
//    a few particles: on jittered inputs 36% (sphere25m) and 18%
//    (dambreak12m) of the slots are active.  The placement fills a tile from
//    slot 0 and a slot only goes inactive between rebuilds, so L is tight; it
//    is read from the tile's own active column, so it holds for any layout.
//    A block reads the valid flags and active columns of the candidate
//    tiles it claims at once (a lane a tile from the column's end, then a
//    warp a column for the tiles that end early) and lists the occupied ones
//    with their L: the ring loads only listed tiles, so a run of dead tiles
//    costs no stage and never leaves a live tile's load un-overlapped.
//  * With dead tiles nearly free a block's time is its live tiles', and a
//    fixed share of the tiles left the busiest block 8-13% above the mean
//    (a model of the static walk on the benchmark's jittered states).  So
//    the tiles are handed out at run time: a block claims the next chunk of
//    the range, in tile order, from a cursor in the launch's zeroed margin
//    words (``list_tiles``): 8 tiles after a claim that listed a live tile
//    (fewer where a block's share of the range is under 64 tiles), twice
//    the last claim after one that listed none (up to 256 and to the
//    unclaimed tiles over twice the grid).  Measured on an H100 at 700 W
//    (scripts/prof_k1.py --cells, the benchmark's jittered states, against
//    the static walk in the same call): sphere25m 6.58-6.74 ms at set-up
//    and 7.29-7.57 after 20 substeps against 7.00-7.35 and 7.97-8.16,
//    dambreak12m 2.73-2.94 against 3.13-3.54, the busiest block's span
//    1.2-3.6% above the mean (``block_balance_counter``), 26-60 claims a
//    block.  What each part of the rule is for:
//    - tile order: a block's consecutive tiles share neighbour rows; the
//      same claims taken down the static walk's columns (tile b + i x
//      grid) ran 2-7% slower;
//    - small chunks where tiles are live: chunks of the unclaimed tiles
//      over twice the grid (guided scheduling) assume the live tiles
//      spread evenly, but the rebucket fills tiles from 0 and leaves the
//      capacity's slack at the end, so dambreak12m's first chunks held
//      160 live tiles and its busiest block ran 1.6-1.9x the mean (4.4 ms);
//    - doubling over dead tiles: chunks of 8 everywhere took 42 claims a
//      block on dambreak12m's slack (2.88-2.96 ms) against 27;
//    - the floor scaled to the range: at 1-2M particles (4-7k tiles)
//      chunks of 8 left blocks 1.2-1.7x the mean, and K1-SD took 0.77-0.85
//      ms against the static walk's 0.68-0.69 (0.64-0.70 scaled).
//  * Every slot loop runs over [0, L); the stage past L
//    holds an earlier tile's bytes and is never read.  Position and fields
//    are written back over [0, L) only: past it they stay as the caller's
//    output held them (inactive slots' state is undefined after the
//    transfer).  Active and pid are written for every slot, 0 and S past L
//    and over every tile the list skips (5 bytes a slot).  A device counter
//    (ops/g2p2g_kernel.py:streamed_slot_counter) sums the L of every
//    streamed tile, one atomic a block, and another
//    (block_balance_counter) each block's live tiles, span on %globaltimer
//    and claims, six atomics a block; the substep reads neither.
//  * Phase 1, one slot per thread: G2P, the material, advection, the range
//    checks and the margin; the particle's m v and Q go to shared memory.
//  * P2G with ~7x fewer atomics: the block counting-sorts its particles by
//    post-advection stencil base (<= 6^3 bases in an arena, ~7 particles a
//    base at 8 per cell).  Then one thread per (occupied base, channel) sums
//    its base's particles' 27 node terms in registers and adds them to the
//    arena with 27 shared atomicAdds.  The 4 channels of a base sit on
//    adjacent lanes and a warp holds 8 bases, so a warp's adds hit 32
//    distinct words and (arena strides padded) mostly distinct banks: no
//    lane waits on another.  Which order the slots of a tile come in no
//    longer changes the work.  The price is arithmetic: each of the 4 lanes
//    of a base recomputes the particle's weights, and a lane idles while
//    the fullest base of its warp finishes.  This is the binned P2G of Gao
//    et al. 2018 ("GPU Optimization of Material Point Methods") with the
//    run reduction done in registers instead of by warp shuffles (5
//    shuffle steps for each of 108 values).  Per-warp arenas instead would
//    take 8 x 9 KB more shared memory, one block per SM, and still pay the
//    compare-and-swap loop per particle and node: on this file, with the
//    particles sorted and spread so that no two lanes of a warp shared a
//    cell, those loops alone cost 4.6 of 9.3 ms (against plain
//    read-add-writes).
//  * The flush adds each nonzero float4 of the arena with one vector global
//    atomic (native on sm_90), skipping the null oct.
//  * The drift margin, min over axes of min(c, 6 - c) (span 4: 14 - c) with
//    c = x dx_inv - 0.5 - origin for every particle that ends active, is
//    computed with _rn intrinsics (bit-equal to arena_margin) and reduced to
//    one atomicMax per block on an order-reversing integer image; the last
//    block decodes it into the 0-d output.
// Measured on an H100 at 700 W (scripts/prof_k1.py and ablations of this
// file, the sphere25m lattice state, FixedCorotated): 5.1-5.4 ms in any slot
// order; with every tile dead 1.7-1.8 ms (the stream alone, 1.3x its 1.31
// ms bytes bound, before dead tiles left the ring); without the P2G phase
// 2.9 ms.  So the per-base P2G (~2.2 ms, its atomics ~0.45 of it) and the
// stream are what is left.  The register
// budget is 128 for FC, Sand and NACC at 2 blocks (16 warps) per SM and 80
// for JFluid at 3 (JFluid at 2 blocks and 128 registers ran 1.2x slower),
// with no spills; shared memory (~72-110 KB a block at tile 512) allows no
// more warps.
// Global and shared float atomics change the summation order from run to
// run: results agree with the plain version to float32 roundoff, not bit
// for bit.  No tensor cores: the TPU kernel's contractions over the
// particle axis are matrix products only because the TPU has nothing else
// fast; here the sums are direct.
//
// The arena span.  The kernel is a template on it too.  Span 2 (rebucket_every
// <= 2) is the design above: the 2^3 blocks from the home block up, 8 cells a
// side, 6^3 stencil bases.  Span 4 (rebucket_every 3..8, the lazy rebucket)
// reaches one block below the home block and two above: 4^3 = 64 blocks, 16
// cells a side, arena origin (bcoord - 1) * 4.  Its range checks (a stencil
// base outside 0..13 deactivates the particle) and its margin min(c, 14 - c)
// are the whole arena's.  Its first design kept a 16^3 (m, mv) arena (~166 KB
// a block, one block per SM, 240-244 registers) and read every G2P node from
// pool_v: 14.7% of its bound (FixedCorotated 9.24 ms on a sphere25m span-4
// state against 5.39 at span 2).  But a tile's particles share one home
// block at a rebuild (bases 5..8 of 0..13 on each axis) and, under the CFL
// step (under half a cell a substep) in a smooth velocity field, move
// together, so their stencils nearly always fit 8 cells.  So span 4 works in
// per-tile windows of the arena with span 2's shared memory: 8 cells in x
// and y, 12 in z (8 rounded out to whole float4s of the pool's cz lanes, so
// that any z origin flushes and stages by 16 bytes and fits every 6-base
// range):
//  * G2P: when a tile's stage has landed, the block's min/max of its
//    pre-advection bases places a velocity window (origin min(lo, 8), z
//    rounded down to a multiple of 4), staged by 16-byte cp.async while the
//    tile before runs its P2G and flush.  A particle whose stencil leaves the
//    window reads pool_v through the read-only cache: the same floats.
//  * P2G: the block's min/max of the post-advection bases is the tile's
//    extent.  Each 6-base range of it an axis (nearly always one) is one pass
//    of span 2's binned P2G over a window at origin min(lo + 6 p, 8): 216
//    bins, the (m, mv) window, a flush of its 768 float4s through the
//    neighbour list (null blocks skipped).  A wider tile takes up to 27
//    passes, each exact; the kernel counts such tiles in a device counter
//    (ops/g2p2g_kernel.py:wide_tile_counter) that the substep never reads.
//    The pass state sits in shared memory, so that JFluid's 80 registers do
//    not spill.
// Both spans run at the same occupancy (FixedCorotated, Sand, NACC: 128
// registers, 2 blocks per SM at tile 512; JFluid 80 and 3) and every tile
// of 32..1024 fits (1024: one block per SM).  ``cm_g2p2g_info`` reports the
// shared memory and blocks per SM of every (material, span, tile); a layout
// that did not fit would report 0 blocks, and the wrapper would raise.
// Measured on an H100 at 700 W (scripts/prof_k1.py, the first design and
// this one alternating in one call): FixedCorotated 9.08-9.33 -> 5.88-5.98
// ms on the sphere25m span-4 state (span 2: 5.33-5.38), 23% of its bound;
// JFluid 0.61-0.65 -> 0.39-0.43, Sand 1.10-1.16 -> 0.75-0.84, NACC
// 1.18-1.27 -> 0.78-0.84.  Every 4th tile spread over its arena (a quarter
// of the tiles wide) costs FixedCorotated 10.5-10.6 ms: a pass per range.
//
// Layouts (the JAX package's): pool f32[O+1, 16, 128], rows (channel c, cx),
// lanes (z8, cy, cz), row O the null oct; a block address is
// oct_row * 8 + z8.  Particles are slot-major and component-leading:
// pos f32[3, S], F f32[9, S], J or logJp f32[S], active bool[S], pid i32[S],
// S = T * tile.  The wrapper checks 32 <= tile <= 1024 (a power of two) and
// 16-byte alignment, which the bulk copies need.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowFloats = 16 * 128;
constexpr int kMaxParams = 16;
constexpr int kMinTile = 32, kMaxTile = 1024;
constexpr int kP2G = 12;                      // m v (3) and Q (9) per particle
constexpr int kTileList = kThreads;           // the most tiles a block claims at once
constexpr int kSlotRound = 16;                // an occupied prefix is whole 16-slot runs

// the transfer arena of span kSpan blocks a side.  The shared-memory arenas
// (velocities for the G2P, (m, mv) for the P2G) are 8 cells in x and y: at
// span 2 the whole arena, at span 4 a window of it placed per tile, 12
// cells in z there so that any 8-cell z range fits inside whole float4s of
// the pool's cz lanes
template <int kSpan_>
struct Arena {
  static constexpr int kSpan = kSpan_;
  static constexpr int kLo = kSpan == 2 ? 0 : -1;   // first block, from the home block
  static constexpr int kCells = 4 * kSpan;          // cells per axis
  static constexpr int kNb = kSpan * kSpan * kSpan; // neighbour blocks
  static constexpr int kNbShift = kSpan == 2 ? 3 : 6;
  static constexpr bool kWindow = kSpan == 4;       // per-tile windows of the arena
  static constexpr int kWz = kWindow ? 12 : 8;      // shared arena cells in z
  static constexpr int kYS = kWz;                   // strides in floats, padded so
  static constexpr int kXS = 8 * kWz + 4;           // that the P2G's lanes (bases x
  static constexpr int kChan = 8 * kXS + 8;         // channels) spread over the banks
  static constexpr int kW = 6;                      // stencil bases per axis (P2G bins)
  static constexpr int kBases = kW * kW * kW;
  static constexpr int kBins = kBases + 1;          // + slots with no stencil
  static constexpr int kVelStages = kWindow ? 1 : 2;  // velocity arenas in the ring
};
using Span2 = Arena<2>;
using Span4 = Arena<4>;

// span 4: a slot's arena-relative post-advection stencil base, 4 bits an
// axis (x high), or kNoBase for a slot with no P2G
constexpr int kNoBase = 0xFFFF;

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
  unsigned int* margin_key;     // u32[3]: key, finished blocks, the candidate cursor;
                                // zeroed by the wrapper
  float* margin_out;            // f32[]
  unsigned int* wide_tiles;     // u32[1]: span 4, tiles whose P2G took several passes
  unsigned long long* streamed; // u64[1]: slots of the occupied prefixes streamed
  unsigned long long* balance;  // u64[6]: blocks, live tiles (sum, max), block ns (sum,
                                // max), claims
  int num_tiles, tile_lo, tile_hi, tile, g, gzo, num_oct_keys, null_oct;
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

// F <- (I + dt D^-1 A) F; f is the particle's F column in the stage
// (component k at f[k * stride]), read here and overwritten by store_f
__device__ __forceinline__ void deformation_update(const Params& p,
                                                   const float A[9], float dt,
                                                   const float* f, int stride,
                                                   float Fn[9]) {
  float Fo[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) Fo[k] = f[k * stride];
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

__device__ __forceinline__ void store_f(float* f, int stride, const float v[9]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k * stride] = v[k];
}

// ---------------------------------------------------------------------------
// materials: field layout + update(params, A, dt, F, aux, stride) -> contrib;
// F and aux point at the particle's slot in the stage and are updated there
// ---------------------------------------------------------------------------

// mp: 2 mu, lam, volume
struct FixedCorotated {
  static constexpr bool kF = true, kAux = false;
  static constexpr int kMinBlocks = 2;
  __device__ static void update(const Params& p, const float A[9], float dt,
                                float* f, float* aux, int stride, float contrib[9]) {
    float Fn[9], R[9];
    deformation_update(p, A, dt, f, stride, Fn);
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
    store_f(f, stride, Fn);
  }
};

// mp: bulk, -gamma, viscosity, volume
struct JFluid {
  static constexpr bool kF = false, kAux = true;
  static constexpr int kMinBlocks = 3;
  __device__ static void update(const Params& p, const float A[9], float dt,
                                float* f, float* aux, int stride, float contrib[9]) {
    float J = aux[0];
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
    aux[0] = J;
  }
};

// mp: cohesion, (3 lam + 2 mu)/(2 mu), yield surface, exp(cohesion), beta,
//     volume correction (0/1), 2 mu, lam, volume
struct Sand {
  static constexpr bool kF = true, kAux = true;
  static constexpr int kMinBlocks = 2;
  __device__ static void update(const Params& p, const float A[9], float dt,
                                float* fp, float* aux, int stride, float contrib[9]) {
    const float cohesion = p.mp[0], c_dg = p.mp[1], ys = p.mp[2];
    const float s_tip = p.mp[3], beta = p.mp[4];
    const float two_mu = p.mp[6], lam = p.mp[7], volume = p.mp[8];
    float f[9], u[9], v[9], sv[3];
    deformation_update(p, A, dt, fp, stride, f);
    const float log_jp = aux[0];
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
    store_f(fp, stride, f);
    aux[0] = new_log_jp;
  }
};

// mp: mu, bm, xi, -beta, msqr, volume, hardening (0/1), 1.5 (1 + 2 beta),
//     1 - beta, 1 + 2 beta, -bm/2, bm/2
struct NACC {
  static constexpr bool kF = true, kAux = true;
  static constexpr int kMinBlocks = 2;
  __device__ static void update(const Params& p, const float A[9], float dt,
                                float* fp, float* aux, int stride, float contrib[9]) {
    const float mu = p.mp[0], bm = p.mp[1], xi = p.mp[2], neg_beta = p.mp[3];
    const float msqr = p.mp[4], volume = p.mp[5];
    const float ys_half = p.mp[7], one_m_beta = p.mp[8], one_p_2beta = p.mp[9];
    const float neg_bm_half = p.mp[10], bm_half = p.mp[11];
    float f[9], u[9], v[9], sv[3];
    deformation_update(p, A, dt, fp, stride, f);
    const float log_jp = aux[0];
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
    store_f(fp, stride, f);
    aux[0] = new_log_jp;
  }
};

// ---------------------------------------------------------------------------
// shared-memory layout and the asynchronous copies
// ---------------------------------------------------------------------------

// one ring stage: the tile's particle columns, n words each (pos x/y/z, the
// 9 F components, J or logJp, pid), then n active bytes
template <class M>
struct Stage {
  static constexpr int kFw = M::kF ? 9 : 0;
  static constexpr int kAw = M::kAux ? 1 : 0;
  static constexpr int kFo = 3, kAuxo = 3 + kFw, kPid = 3 + kFw + kAw;
  static constexpr int kWords = kPid + 1;
  __host__ __device__ static int bytes(int n) { return n * (4 * kWords + 1); }
};

__host__ __device__ constexpr int round_up(int x, int a) { return (x + a - 1) / a * a; }

struct Layout {                 // byte offsets into the dynamic shared memory
  int bars, nb, misc, ctl, wsum, wext, tlist, hist, blist, perm, sbin, srank, varena, oarena,
      p2g, stage, stage_stride, total;
};

// the tile ring's control words in shared memory (ints): per ring slot b
// its tile and occupied prefix (0: no tile), per take parity b the list
// position, the listed count, the first tile of the block's claim (from
// tile_lo) and its length, the live tiles the block took, the streamed
// slots and the block's start (u64, 8-byte aligned), the block's claims
// and the length of its next claim
enum Ctl { kRingTile = 0, kRingLen = 1, kPos = 4, kCount = 6, kBase = 7, kCand = 8,
           kLive = 9, kStreamed = 10, kStart = 12, kClaims = 14, kNext = 15, kCtlWords = 16 };

template <class M, class A>
__host__ __device__ inline Layout layout(int n) {
  Layout s;
  int o = 0;
  s.bars = o;   o += 16;                      // two mbarriers
  s.nb = o;     o += 2 * A::kNb * 4;          // neighbour block addresses per stage
  s.misc = o;   o += 16;                      // margin key, count of occupied bins
  s.ctl = o;    o += kCtlWords * 4;           // the tile ring's control words
  s.wsum = o;   o += 2 * kWarps * 4;          // per warp: bins and occupied bins
  s.wext = o;                                 // span 4, per warp: the extents of the
  if (A::kWindow) o += kWarps * 16 + 112;     // bases; the velocity window's origin;
                                              // the tile's passes; two pass windows
  s.tlist = o;  o += kTileList * 2;           // the listed tiles: candidate, prefix
  s.hist = o;   o += round_up(A::kBins, 4) * 4;  // bin counts, then bin starts
  s.blist = o;  o += round_up(2 * A::kBases, 16);  // the occupied bins
  s.perm = o;   o += round_up(2 * n, 16);     // sorted position -> slot
  s.sbin = o;   o += round_up(2 * n, 16);     // per slot: its bin (span 4: its packed
  s.srank = o;  o += round_up(2 * n, 16);     // base), its rank in its bin
  o = round_up(o, 128);
  s.varena = o;                               // velocity arenas: one per stage at
  o += A::kVelStages * 3 * A::kChan * 4;      // span 2, one window at span 4
  s.oarena = o; o += 4 * A::kChan * 4;        // (m, mv) arena
  s.p2g = o;    o += kP2G * n * 4;            // per slot: m v and Q, for the P2G
  s.stage = o;
  s.stage_stride = round_up(Stage<M>::bytes(n), 128);
  o += 2 * s.stage_stride;
  s.total = o;
  return s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s_addr(dst)), "l"(src) : "memory");
}

// the ring stage of tile t: slots [0, len) of every particle column by one
// bulk copy each, at the column's place in the stage (len a multiple of 16,
// so every copy is whole 16-byte units)
template <class M>
__device__ __forceinline__ void load_stage(const Params& p, int t, int n, int len, size_t S,
                                           unsigned char* stage, uint64_t* bar) {
  using L = Stage<M>;
  const uint32_t col = (uint32_t)len * 4;
  const size_t s0 = (size_t)t * n;
  float* w = reinterpret_cast<float*>(stage);
  mbar_expect_tx(bar, (uint32_t)L::bytes(len));
#pragma unroll
  for (int c = 0; c < 3; ++c) bulk_load(w + c * n, p.pos + c * S + s0, col, bar);
  if constexpr (M::kF) {
#pragma unroll
    for (int k = 0; k < 9; ++k)
      bulk_load(w + (L::kFo + k) * n, p.F + k * S + s0, col, bar);
  }
  if constexpr (M::kAux) bulk_load(w + L::kAuxo * n, p.aux + s0, col, bar);
  bulk_load(w + L::kPid * n, p.pid + s0, col, bar);
  bulk_load(stage + L::kWords * 4 * n, p.active + s0, (uint32_t)len, bar);
}

__device__ __forceinline__ bool nonzero(uint4 v) { return (v.x | v.y | v.z | v.w) != 0u; }

// the occupied prefix of this lane's candidate tile c, in 16-slot runs: 0
// past the range or for a tile that is not valid, else one past the last
// 16-slot run of its active column holding an active slot.  Each lane reads
// the last two runs of its own tile's column, where a full tile ends; then
// the warp reads the rest of the column of each tile still open (an
// overflow tile's few particles, or none), a run a lane, and takes its last
// nonzero run by ballot.  Few registers: JFluid's budget has no room for
// more loads in flight.  The whole warp calls it
__device__ __forceinline__ int occupied_runs(const Params& p, int c, int n, int lane) {
  const int runs = n / kSlotRound;
  const bool valid = c < p.tile_hi && p.tvalid[c];
  int out = 0;
  if (valid) {
    const uint4* col = reinterpret_cast<const uint4*>(p.active + (size_t)c * n);
    const uint4 a = __ldg(col + runs - 1), b = __ldg(col + runs - 2);
    out = nonzero(a) ? runs : nonzero(b) ? runs - 1 : 0;
  }
  unsigned open = __ballot_sync(0xffffffffu, valid && out == 0);
  while (open) {
    const int j = __ffs(open) - 1;
    open &= open - 1u;
    const uint4* col = reinterpret_cast<const uint4*>(
        p.active + (size_t)__shfl_sync(0xffffffffu, c, j) * n);
    int last = 0;
    for (int r = 0; r < runs - 2; r += 32) {
      const int k = r + lane;
      const unsigned nz = __ballot_sync(0xffffffffu, k < runs - 2 && nonzero(__ldg(col + k)));
      if (nz) last = r + 32 - __clz(nz);
    }
    if (lane == j) out = last;
  }
  return out;
}

// a tile that streams nothing: every slot inactive, pid S, by one warp
__device__ __forceinline__ void clear_tile(const Params& p, int t, int n, int lane) {
  const size_t s0 = (size_t)t * n;
  const int none = p.num_tiles * n;
  uint4* a = reinterpret_cast<uint4*>(p.active_out + s0);
  int4* d = reinterpret_cast<int4*>(p.pid_out + s0);
  for (int i = lane; i < n / 16; i += 32) a[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = lane; i < n / 4; i += 32) d[i] = make_int4(none, none, none, none);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the block's next claim of candidate tiles, listed.  Thread 0 claims the
// next chunk of the range's tiles, in order, from the launch's cursor
// (margin_key[2]) with one atomicAdd: after a claim that listed a live
// tile, the floor, 8 tiles (an oct's padded group) or, where the range
// holds fewer than 64 a block, the range over 8 x the grid (at least 1),
// so that every block takes 8 or more claims; after a claim that listed
// none, twice that claim, but no more than kTileList and than the
// unclaimed tiles over 2 x the grid, so that the capacity's dead tail
// takes few claims and no block is left with a large one at the end.
// Thread k reads tile kBase + k of it: the occupied ones go to ``tlist``
// in order as (k << 8 | runs), the others in the range are cleared; the
// claim's first tile (from tile_lo) and length, the next claim's length
// (0: the floor), the list's count and list position b (0) go to the
// control words.  Every thread calls it; it synchronises before the claim
// (every thread has read the words that brought it here), after it,
// before it writes the list and after
__device__ __forceinline__ void list_tiles(const Params& p, int n, unsigned short* tlist,
                                           volatile int* ctl, int b, int* wsum, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  __syncthreads();
  if (tid == 0) {
    unsigned int* cursor = p.margin_key + 2;
    const int range = p.tile_hi - p.tile_lo, g = (int)gridDim.x;
    const int least = min(max(range / (8 * g), 1), 8);
    int chunk = max(ctl[kNext], least);
    if (chunk > least) {
      const int left = range - (int)*reinterpret_cast<volatile unsigned int*>(cursor);
      chunk = max(min(chunk, left / (2 * g)), least);
    }
    ctl[kBase] = (int)atomicAdd(cursor, (unsigned int)chunk);
    ctl[kCand] = chunk;
    ctl[kClaims] += 1;
  }
  __syncthreads();
  const int c = tid < ctl[kCand] ? p.tile_lo + ctl[kBase] + tid : p.tile_hi;
  const int runs = occupied_runs(p, c, n, lane);
  const unsigned has = __ballot_sync(0xffffffffu, runs > 0);
  unsigned dead = __ballot_sync(0xffffffffu, c < p.tile_hi && runs == 0);
  if (lane == 0) wsum[warp] = __popc(has);
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    off += k < warp ? wsum[k] : 0;
    total += wsum[k];
  }
  if (runs) tlist[off + __popc(has & ((1u << lane) - 1u))] = (unsigned short)((tid << 8) | runs);
  if (tid == 0) {
    ctl[kCount] = total;
    ctl[kPos + b] = 0;
    ctl[kNext] = total ? 0 : min(2 * ctl[kCand], kTileList);
  }
  while (dead) {
    const int j = __ffs(dead) - 1;
    dead &= dead - 1u;
    clear_tile(p, __shfl_sync(0xffffffffu, c, j), n, lane);
  }
  __syncthreads();
}

// block address of neighbour ``k`` = (bx, by, bz) of tile t's arena (the null
// block when inactive)
template <class A>
__device__ __forceinline__ int neighbour(const Params& p, int t, int k) {
  constexpr int S = A::kSpan;
  const int cx = p.bcoord[t] + k / (S * S) + A::kLo,
            cy = p.bcoord[p.num_tiles + t] + (k / S) % S + A::kLo,
            cz = p.bcoord[2 * p.num_tiles + t] + k % S + A::kLo;
  const bool valid = cx >= 0 && cx < p.g && cy >= 0 && cy < p.g && cz >= 0 && cz < p.g;
  const int okey = valid ? (cx * p.g + cy) * p.gzo + (cz >> 3) : p.num_oct_keys;
  const int oslot = p.table[okey];
  return oslot == p.null_oct ? p.null_oct * 8 : oslot * 8 + (cz & 7);
}

// arena offset of float4 ``i`` of a 3- or 4-channel arena, and the pool
// offset it maps to: i = (channel, neighbour block, cx, cy), the float4
// holding cz = 0..3
template <class A>
__device__ __forceinline__ int arena_off4(int i) {
  constexpr int S = A::kSpan;
  const int ch = i >> (A::kNbShift + 4), blk = (i >> 4) & (A::kNb - 1), cx = (i >> 2) & 3,
            cy = i & 3;
  return ch * A::kChan + (blk / (S * S) * 4 + cx) * A::kXS + ((blk / S) % S * 4 + cy) * A::kYS
         + (blk % S) * 4;
}

template <class A>
__device__ __forceinline__ size_t pool_off4(int i, int br, int row0) {
  const int ch = i >> (A::kNbShift + 4), cx = (i >> 2) & 3, cy = i & 3;
  return ((size_t)(br >> 3) * 16 + row0 + ch * 4 + cx) * 128 + (br & 7) * 16 + cy * 4;
}

// the velocity arena of a tile, pool rows 4..15 of its neighbour blocks;
// inactive neighbours read the null row, as the plain version does
template <class A>
__device__ __forceinline__ void stage_velocity(const Params& p, const int* nb,
                                               float* varena, int tid) {
  for (int i = tid; i < 3 * 16 * A::kNb; i += kThreads)
    cp_async16(varena + arena_off4<A>(i),
               p.pool_v + pool_off4<A>(i, nb[(i >> 4) & (A::kNb - 1)], 4));
}

// span 4: the neighbour block (of the 4^3) holding arena cell (cx, cy, cz)
__device__ __forceinline__ int window_block(const int* nb, int cx, int cy, int cz) {
  return nb[((cx >> 2) * 4 + (cy >> 2)) * 4 + (cz >> 2)];
}

// span 4: the velocity window of a tile, arena cells [vx, vx + 8) x [vy, vy
// + 8) x [vz, vz + 12) (vz a multiple of 4), pool rows 4..15 of the blocks
// that hold them; 3 channels x 64 (x, y) x 3 float4s of z
template <class A>
__device__ __forceinline__ void stage_window(const Params& p, const int* nb, float* vwin,
                                             int vx, int vy, int vz, int tid) {
  for (int i = tid; i < 3 * 64 * 3; i += kThreads) {
    const int zg = i / 192, r = i - zg * 192, ch = r >> 6, x = (r >> 3) & 7, y = r & 7;
    const int cx = vx + x, cy = vy + y;
    const int br = window_block(nb, cx, cy, vz + 4 * zg);
    cp_async16(vwin + ch * A::kChan + x * A::kXS + y * A::kYS + 4 * zg,
               p.pool_v + ((size_t)(br >> 3) * 16 + 4 + ch * 4 + (cx & 3)) * 128
                   + (br & 7) * 16 + (cy & 3) * 4);
  }
}

// span 4: per-byte min and max over a warp of bases packed one axis a byte
__device__ __forceinline__ uint32_t warp_min3(uint32_t v) {
  return __reduce_min_sync(0xffffffffu, v & 255u)
       | (__reduce_min_sync(0xffffffffu, (v >> 8) & 255u) << 8)
       | (__reduce_min_sync(0xffffffffu, (v >> 16) & 255u) << 16);
}

__device__ __forceinline__ uint32_t warp_max3(uint32_t v) {
  return __reduce_max_sync(0xffffffffu, v & 255u)
       | (__reduce_max_sync(0xffffffffu, (v >> 8) & 255u) << 8)
       | (__reduce_max_sync(0xffffffffu, (v >> 16) & 255u) << 16);
}

constexpr uint32_t kNoExtent = 0x0F0F0Fu;     // the min of no base: 15 > 13 an axis

// span 4: the extent (per-byte min, max) of the arena-relative pre-advection
// stencil bases, clamped into the arena as the G2P clamps them, of this
// thread's active slots of tile t's stage (its occupied prefix ``len``)
template <class A>
__device__ __forceinline__ void pre_extent(const Params& p, int t, int n, int len,
                                           const float* sw, const unsigned char* sact,
                                           int tid, uint32_t& lo, uint32_t& hi) {
  int org[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) org[a] = (p.bcoord[a * p.num_tiles + t] + A::kLo) * 4;
  for (int q = tid; q < len; q += kThreads) {
    if (!sact[q]) continue;
    uint32_t v = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int base = (int)floorf(sw[a * n + q] * p.dx_inv + 0.5f) - 1;
      v |= (uint32_t)min(max(base - org[a], 0), A::kCells - 3) << (8 * a);
    }
    lo = __vminu4(lo, v);
    hi = __vmaxu4(hi, v);
  }
}

// the 27-node G2P sums of one particle: velocity and APIC moment A[r*3+c];
// fetch(i, j, k, vr) gives node (l + (i, j, k))'s 3 velocity components
template <class Fetch>
__device__ __forceinline__ void g2p_nodes(const float w[3][3], const float mw[3][3],
                                          Fetch fetch, float v[3], float A[9]) {
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
        float vr[3];
        fetch(i, j, k, vr);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          v[r] += W * vr[r];
          A[r * 3 + 0] += Wx * vr[r];
          A[r * 3 + 1] += Wy * vr[r];
          A[r * 3 + 2] += Wz * vr[r];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the transfer
// ---------------------------------------------------------------------------

// quadratic B-spline weights and moment weights w * (cell - x) per axis;
// returns false when the stencil leaves the arena (it is then clamped in)
template <class A>
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
    in_range = in_range && rel >= 0 && rel <= A::kCells - 3;
    l[a] = min(max(rel, 0), A::kCells - 3);
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

// order-reversing u32 image of a margin: the block and grid reductions take
// the max, so the smallest margin wins; NaN maps to the top (it wins, as in
// torch's min) and 0 stands for "no particle" (+inf)
__device__ __forceinline__ uint32_t margin_key(float m) {
  if (isnan(m)) return 0xFFFFFFFFu;
  const uint32_t b = __float_as_uint(m);
  return ~((b & 0x80000000u) ? ~b : (b | 0x80000000u));
}

__device__ __forceinline__ float margin_value(uint32_t key) {
  if (key == 0u) return INFINITY;
  if (key == 0xFFFFFFFFu) return NAN;
  const uint32_t img = ~key;
  return __uint_as_float((img & 0x80000000u) ? (img & 0x7FFFFFFFu) : ~img);
}

// one particle of a live tile, in place in the stage: G2P, the material,
// advection, the range checks and the margin; m v and Q go to the slot's
// column of ``pg`` for the P2G.  Returns the post-advection stencil base,
// 0..kBases-1, or kBases when the particle left the arena; at span 4 the
// arena-relative base packed 4 bits an axis, or kNoBase.  The G2P reads the
// staged velocity arena at span 2; at span 4 the tile's velocity window
// (origin ``vo``) when the stencil lies in it, else pool_v through the
// read-only cache: the same floats either way
template <class M, class Ar>
__device__ __forceinline__ int transfer_particle(
    const Params& p, int n, int q, float* sw, unsigned char* sact,
    const float* varena, const int* nbs, const int* vo, float* pg, const int org[3],
    float dt, float next_dt, uint32_t& kmax) {
  using L = Stage<M>;
  float x[3] = {sw[q], sw[n + q], sw[2 * n + q]};

  // ---- G2P: velocity and APIC moment, A[r*3+c] ----
  int l[3];
  float w[3][3], mw[3][3];
  const bool in_pre = stencil<Ar>(p, x, org, l, w, mw);
  float v[3] = {0.0f, 0.0f, 0.0f};
  float A[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) A[k] = 0.0f;
  if constexpr (!Ar::kWindow) {
    g2p_nodes(w, mw, [&](int i, int j, int k, float vr[3]) {
      const int idx = (l[0] + i) * Ar::kXS + (l[1] + j) * Ar::kYS + l[2] + k;
#pragma unroll
      for (int r = 0; r < 3; ++r) vr[r] = varena[r * Ar::kChan + idx];
    }, v, A);
  } else {
    const int wx = l[0] - vo[0], wy = l[1] - vo[1], wz = l[2] - vo[2];
    if ((unsigned)wx <= 5u && (unsigned)wy <= 5u && (unsigned)wz <= (unsigned)(Ar::kWz - 3)) {
      const float* src = varena + wx * Ar::kXS + wy * Ar::kYS + wz;
      g2p_nodes(w, mw, [&](int i, int j, int k, float vr[3]) {
#pragma unroll
        for (int r = 0; r < 3; ++r) vr[r] = src[r * Ar::kChan + i * Ar::kXS + j * Ar::kYS + k];
      }, v, A);
    } else {
      g2p_nodes(w, mw, [&](int i, int j, int k, float vr[3]) {
        const int ax = l[0] + i, ay = l[1] + j, az = l[2] + k;
        const int br = window_block(nbs, ax, ay, az);
        const float* src = p.pool_v + ((size_t)(br >> 3) * 16 + 4 + (ax & 3)) * 128
                           + (br & 7) * 16 + (ay & 3) * 4 + (az & 3);
#pragma unroll
        for (int r = 0; r < 3; ++r) vr[r] = __ldg(src + r * 4 * 128);
      }, v, A);
    }
  }

  // ---- the material: new fields and the stress contribution ----
  float contrib[9];
  M::update(p, A, dt, sw + L::kFo * n + q, sw + L::kAuxo * n + q, n, contrib);

  // ---- advection, the post-advection range check and the margin ----
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    x[a] = x[a] + v[a] * dt;
    sw[a * n + q] = x[a];
  }
  const bool ok = in_pre && stencil<Ar>(p, x, org, l, w, mw);
  sact[q] = ok ? 1 : 0;
  if (!ok) return Ar::kWindow ? kNoBase : Ar::kBases;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    // arena_margin: c = x dx_inv - 0.5 - origin, min(c, (cells - 2) - c)
    const float c = __fsub_rn(__fsub_rn(__fmul_rn(x[a], p.dx_inv), 0.5f), (float)org[a]);
    kmax = max(kmax, max(margin_key(c), margin_key(__fsub_rn((float)(Ar::kCells - 2), c))));
  }

  // ---- what the P2G needs besides the position: m v and Q ----
#pragma unroll
  for (int r = 0; r < 3; ++r) pg[r * n + q] = v[r] * p.mass;
#pragma unroll
  for (int k = 0; k < 9; ++k)
    pg[(3 + k) * n + q] = (A[k] * p.mass - contrib[k] * next_dt) * p.d_inv;
  if constexpr (Ar::kWindow) return (l[0] << 8) | (l[1] << 4) | l[2];
  return (l[0] * Ar::kW + l[1]) * Ar::kW + l[2];
}

// the P2G of one channel (0 mass, 1..3 momentum) of the particles of one
// stencil base b, slots perm[start .. start + cnt): each particle's 27 node
// terms w m (mass) or w (m v_r + Q_r. (x_i - x_p)) sum in registers, and
// the base's 27 nodes take one shared atomicAdd each
template <class Ar>
__device__ __forceinline__ void p2g_base(const Params& p, int n, int b, int ch, int start,
                                         int cnt, const unsigned short* perm,
                                         const float* sw, const float* pg, float* oarena,
                                         const int org[3]) {
  float acc[27];
#pragma unroll
  for (int k = 0; k < 27; ++k) acc[k] = 0.0f;
  for (int e = 0; e < cnt; ++e) {
    const int q = perm[start + e];
    const float x[3] = {sw[q], sw[n + q], sw[2 * n + q]};
    int l[3];
    float w[3][3], mw[3][3];
    stencil<Ar>(p, x, org, l, w, mw);
    // the factors of w and of the three moment weights; the mass channel's
    // moment terms are zero
    float f0 = p.mass, f1 = 0.0f, f2 = 0.0f, f3 = 0.0f;
    if (ch) {
      f0 = pg[(ch - 1) * n + q];
      f1 = pg[(3 * ch) * n + q];
      f2 = pg[(3 * ch + 1) * n + q];
      f3 = pg[(3 * ch + 2) * n + q];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float wxy = w[0][i] * w[1][j];
        const float mxwy = mw[0][i] * w[1][j];
        const float wxmy = w[0][i] * mw[1][j];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          acc[(i * 3 + j) * 3 + k] += (wxy * w[2][k]) * f0 + (mxwy * w[2][k]) * f1
                                      + (wxmy * w[2][k]) * f2 + (wxy * mw[2][k]) * f3;
      }
    }
  }
  const int lx = b / (Ar::kW * Ar::kW), ly = (b / Ar::kW) % Ar::kW, lz = b % Ar::kW;
  float* ob = oarena + ch * Ar::kChan + lx * Ar::kXS + ly * Ar::kYS + lz;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        atomicAdd(&ob[i * Ar::kXS + j * Ar::kYS + k], acc[(i * 3 + j) * 3 + k]);
}

// exclusive scan of the bin counts in ``hist`` in place, the occupied bins
// (not the last, "no stencil") listed in ``blist`` and counted in ``n_occ``.
// Each thread scans a run of consecutive bins, the warps' totals meet in
// ``wsum``.  The caller synchronises before and after
template <class A>
__device__ __forceinline__ void scan_bins(int* hist, unsigned short* blist, int* n_occ,
                                          int* wsum, int tid) {
  constexpr int kPer = (A::kBins + kThreads - 1) / kThreads;
  const int lane = tid & 31, warp = tid >> 5, b0 = tid * kPer;
  int c[kPer], sum = 0, occ = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = b0 + j;
    c[j] = b < A::kBins ? hist[b] : 0;
    sum += c[j];
    occ += (b < A::kBases && c[j] > 0);
  }
  int inc = sum, inc_occ = occ;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    const int z = __shfl_up_sync(0xffffffffu, inc_occ, d);
    if (lane >= d) {
      inc += y;
      inc_occ += z;
    }
  }
  if (lane == 31) {
    wsum[warp] = inc;
    wsum[kWarps + warp] = inc_occ;
  }
  __syncthreads();
  int run = inc - sum, slot = inc_occ - occ;
  for (int k = 0; k < warp; ++k) {
    run += wsum[k];
    slot += wsum[kWarps + k];
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = b0 + j;
    if (b < A::kBins) hist[b] = run;
    if (b < A::kBases && c[j] > 0) blist[slot++] = (unsigned short)b;
    run += c[j];
  }
  if (tid == kThreads - 1) *n_occ = slot;
}

// span 4: the window bin of a slot's packed base in P2G pass ``ps`` of
// tile extent ``lo``: the pass of a base is (base - lo) / 6 an axis; the
// bin is the base relative to the pass's window origin ``o``
__device__ __forceinline__ int window_bin(int pb, const int lo[3], const int ps[3],
                                          const int o[3]) {
  if (pb == kNoBase) return Span4::kBases;
  const int b[3] = {pb >> 8, (pb >> 4) & 15, pb & 15};
#pragma unroll
  for (int a = 0; a < 3; ++a)
    if ((b[a] - lo[a]) / Span4::kW != ps[a]) return Span4::kBases;
  return ((b[0] - o[0]) * Span4::kW + b[1] - o[1]) * Span4::kW + b[2] - o[2];
}

template <class M, class Ar>
__global__ void __launch_bounds__(kThreads, M::kMinBlocks)
    g2p2g_kernel(const Params p) {
  using L = Stage<M>;
  constexpr int kNb = Ar::kNb;
  static_assert(!Ar::kWindow || kThreads == 4 * 8 * 8, "the window flush: a thread a row");
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = p.tile;
  const Layout lay = layout<M, Ar>(n);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bars);
  int* nb = reinterpret_cast<int*>(smem + lay.nb);
  uint32_t* blk_key = reinterpret_cast<uint32_t*>(smem + lay.misc);
  int* hist = reinterpret_cast<int*>(smem + lay.hist);
  int* n_occ = reinterpret_cast<int*>(smem + lay.misc) + 1;
  // read where used, not held in registers across the transfer
  volatile int* ctl = reinterpret_cast<volatile int*>(smem + lay.ctl);
  unsigned long long* streamed =
      reinterpret_cast<unsigned long long*>(smem + lay.ctl) + kStreamed / 2;
  unsigned long long* start = reinterpret_cast<unsigned long long*>(smem + lay.ctl) + kStart / 2;
  unsigned short* tlist = reinterpret_cast<unsigned short*>(smem + lay.tlist);
  int* wsum = reinterpret_cast<int*>(smem + lay.wsum);
  uint4* wext = reinterpret_cast<uint4*>(smem + lay.wext);
  int* vorg = reinterpret_cast<int*>(smem + lay.wext + kWarps * 16);
  // span 4: the tile's P2G passes (lo[3], np[3], count) and, by pass
  // parity, a pass's window (o[3], ps[3], az): in shared memory, so that
  // none is held in registers across the P2G
  int* ptile = vorg + 4;
  int* pwin = vorg + 12;
  unsigned short* blist = reinterpret_cast<unsigned short*>(smem + lay.blist);
  unsigned short* perm = reinterpret_cast<unsigned short*>(smem + lay.perm);
  unsigned short* sbin = reinterpret_cast<unsigned short*>(smem + lay.sbin);
  unsigned short* srank = reinterpret_cast<unsigned short*>(smem + lay.srank);
  float* varenas = reinterpret_cast<float*>(smem + lay.varena);
  float* oarena = reinterpret_cast<float*>(smem + lay.oarena);
  float* pg = reinterpret_cast<float*>(smem + lay.p2g);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t S = (size_t)p.num_tiles * n;
  const int n4 = n >> 2;

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    *blk_key = 0u;
    ctl[kPos] = ctl[kCount] = ctl[kBase] = ctl[kLive] = ctl[kClaims] = ctl[kNext] = 0;
    *streamed = 0ull;
    *start = global_ns();
  }
  for (int i = tid; i < 4 * Ar::kChan; i += kThreads) oarena[i] = 0.0f;
  for (int i = tid; i < Ar::kBins; i += kThreads) hist[i] = 0;
  // the null row absorbs nothing from this kernel (null-block flushes are
  // skipped), so one block clears it without racing anyone
  if (blockIdx.x == 0) {
    float4* nrow = reinterpret_cast<float4*>(p.next_pool + (size_t)p.null_oct * kRowFloats);
    for (int i = tid; i < kRowFloats / 4; i += kThreads)
      nrow[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  const float dt = *p.dt_ptr;
  const float next_dt = *p.next_dt_ptr;
  uint32_t kmax = 0u;

  // span 4, where ``stage_next``: the velocity window of tile tn (occupied
  // prefix ``tn_len``), whose stage (ring stage s) has landed.  The block's
  // extent of its pre-advection bases places the window (origin min(lo, 8)
  // in x and y, z rounded down to whole float4s), whose copies are then
  // issued; a tile with no active slot stages nothing.  Also reduces this
  // thread's extent of the current tile's post-advection bases (post_lo,
  // post_hi) to the block's, in ``post``.  Its barrier also orders the
  // copies after every thread's G2P from the window they overwrite
  auto window_extents = [&](bool stage_next, int tn, int tn_len, int s, uint32_t post_lo,
                            uint32_t post_hi, uint32_t post[2]) {
    uint32_t lo = kNoExtent, hi = 0u;
    if (stage_next) {
      unsigned char* st = smem + lay.stage + s * lay.stage_stride;
      pre_extent<Ar>(p, tn, n, tn_len, reinterpret_cast<const float*>(st),
                     st + L::kWords * 4 * n, tid, lo, hi);
    }
    lo = warp_min3(lo);
    hi = warp_max3(hi);
    post_lo = warp_min3(post_lo);
    post_hi = warp_max3(post_hi);
    if (lane == 0) wext[warp] = make_uint4(lo, hi, post_lo, post_hi);
    __syncthreads();
    lo = kNoExtent; hi = 0u; post[0] = kNoExtent; post[1] = 0u;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const uint4 e = wext[k];
      lo = __vminu4(lo, e.x);
      hi = __vmaxu4(hi, e.y);
      post[0] = __vminu4(post[0], e.z);
      post[1] = __vmaxu4(post[1], e.w);
    }
    if (stage_next && (lo & 255u) <= (hi & 255u)) {
      const int vx = min((int)(lo & 255u), 8), vy = min((int)((lo >> 8) & 255u), 8),
                vz = min((int)((lo >> 16) & 255u) & ~3, 4);
      stage_window<Ar>(p, nb + s * kNb, varenas, vx, vy, vz, tid);
      // read by this tile's transfer, after the syncs of the tile before
      if (tid == 0) {
        vorg[0] = vx;
        vorg[1] = vy;
        vorg[2] = vz;
      }
    }
  };

  // the block's next tile with an occupied prefix, in the order of its
  // claims (``list_tiles``), into ring slot b (prefix 0: none left, once a
  // claim starts past the candidates).  The list position is kept per take
  // parity (b), so that thread 0 writes one while the others read the
  // other.  Every thread calls it alike after a barrier; it ends with one
  auto take = [&](int b) {
    while (ctl[kPos + b] == ctl[kCount] && ctl[kBase] < p.tile_hi - p.tile_lo)
      list_tiles(p, n, tlist, ctl, b, wsum, tid);
    if (tid == 0) {
      const int pos = ctl[kPos + b];
      int tile = 0, len = 0;
      if (pos < ctl[kCount]) {
        const int e = tlist[pos];
        tile = p.tile_lo + ctl[kBase] + (e >> 8);
        len = (e & 255) * kSlotRound;
        *streamed += len;
        ctl[kLive] += 1;
      }
      ctl[kPos + (b ^ 1)] = pos + (len > 0);
      ctl[kRingTile + 2 * b] = tile;
      ctl[kRingLen + 2 * b] = len;
    }
    __syncthreads();
  };

  // prologue: the first tile's stage, neighbours and velocities, and which
  // tile follows it
  take(0);
  if (ctl[kRingLen] > 0) {
    const int t0 = ctl[kRingTile];
    if (tid == 0) load_stage<M>(p, t0, n, ctl[kRingLen], S, smem + lay.stage, &bar[0]);
    for (int k = tid; k < kNb; k += kThreads) nb[k] = neighbour<Ar>(p, t0, k);
  }
  take(1);
  if (ctl[kRingLen] > 0) {
    if constexpr (!Ar::kWindow) {
      stage_velocity<Ar>(p, nb, varenas, tid);
    } else {
      mbar_wait(&bar[0], 0);
      uint32_t unused[2];
      window_extents(true, ctl[kRingTile], ctl[kRingLen], 0, kNoExtent, 0u, unused);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");

  for (int it = 0; ctl[kRingLen + 2 * (it & 1)] > 0; ++it) {
    const int s = it & 1;
    unsigned char* st = smem + lay.stage + s * lay.stage_stride;
    float* sw = reinterpret_cast<float*>(st);
    unsigned char* sact = st + L::kWords * 4 * n;
    const int* spid = reinterpret_cast<const int*>(sw + L::kPid * n);
    const float* varena = varenas + (Ar::kWindow ? 0 : s * 3 * Ar::kChan);
    const int* nbs = nb + s * kNb;
    // this tile (t, its prefix) and the next (none where its prefix is 0),
    // read from the ring where used
    volatile int* cur = ctl + 2 * s;
    volatile int* nxt = ctl + 2 * (s ^ 1);

    // the next tile streams into the other stage while this one computes;
    // the end-of-iteration barrier freed that stage and its neighbour list
    if (nxt[kRingLen] > 0) {
      const int tn = nxt[kRingTile];
      if (tid == 0)
        load_stage<M>(p, tn, n, nxt[kRingLen], S,
                      smem + lay.stage + (s ^ 1) * lay.stage_stride, &bar[s ^ 1]);
      for (int k = tid; k < kNb; k += kThreads) nb[(s ^ 1) * kNb + k] = neighbour<Ar>(p, tn, k);
    }
    mbar_wait(&bar[s], (it >> 1) & 1);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();                      // this tile's velocities, next's neighbours
    if constexpr (!Ar::kWindow) {
      if (nxt[kRingLen] > 0)
        stage_velocity<Ar>(p, nb + (s ^ 1) * kNb, varenas + (s ^ 1) * 3 * Ar::kChan, tid);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");

    const int t = cur[kRingTile];
    const int org[3] = {(p.bcoord[t] + Ar::kLo) * 4,
                        (p.bcoord[p.num_tiles + t] + Ar::kLo) * 4,
                        (p.bcoord[2 * p.num_tiles + t] + Ar::kLo) * 4};
    // the transfer, one slot per thread in slot order; each particle's
    // post-advection stencil base is its P2G bin (kBases: no P2G; span 4:
    // the packed base, kNoBase).  Bins and ranks wait in shared memory:
    // held in registers across the transfer they would spill at JFluid's
    // 80-register budget
#pragma unroll 1
    for (int q = tid; q < cur[kRingLen]; q += kThreads)
      sbin[q] = (unsigned short)(sact[q] ? transfer_particle<M, Ar>(
                                               p, n, q, sw, sact, varena, nbs, vorg, pg, org,
                                               dt, next_dt, kmax)
                                         : (Ar::kWindow ? kNoBase : Ar::kBases));

    // span 4: this tile's extent of post-advection bases (its P2G windows)
    // and the next tile's velocity window, whose copies land while this tile
    // runs its P2G and flush.  Every slot's bin sits in sbin since the
    // thread that wrote it reads it here
    if constexpr (Ar::kWindow) {
      uint32_t plo = kNoExtent, phi = 0u;
      for (int q = tid; q < cur[kRingLen]; q += kThreads) {
        const int pb = sbin[q];
        if (pb == kNoBase) continue;
        const uint32_t v = (uint32_t)(pb >> 8) | ((uint32_t)((pb >> 4) & 15) << 8)
                           | ((uint32_t)(pb & 15) << 16);
        plo = __vminu4(plo, v);
        phi = __vmaxu4(phi, v);
      }
      const bool next = nxt[kRingLen] > 0;
      if (next) mbar_wait(&bar[s ^ 1], ((it + 1) >> 1) & 1);
      uint32_t post[2];
      window_extents(next, nxt[kRingTile], nxt[kRingLen], s ^ 1, plo, phi, post);
      asm volatile("cp.async.commit_group;" ::: "memory");
      if (tid == 0) {
        int passes = 0;
        if ((post[0] & 255u) <= (post[1] & 255u)) {
          passes = 1;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            ptile[a] = (post[0] >> (8 * a)) & 255u;
            ptile[3 + a] = ((int)((post[1] >> (8 * a)) & 255u) - ptile[a]) / Ar::kW + 1;
            passes *= ptile[3 + a];
          }
          if (passes > 1) atomicAdd(p.wide_tiles, 1u);
        }
        ptile[6] = passes;
      }
    }

    // the P2G: one pass over the window of each 6-base range of the tile's
    // extent (span 2, and at span 4 nearly every tile: one)
    for (int pass = 0;; ++pass) {
      // span 4: pass (px, py, pz) takes the bases of [lo + 6 p, lo + 6 p
      // + 5] an axis; its window origin o = min(lo + 6 p, 8) keeps it in
      // the arena, z of the (m, mv) arena rounded down to whole float4s
      int* pw = pwin + 8 * (pass & 1);
      if constexpr (Ar::kWindow) {
        if (tid == 0 && pass < ptile[6]) {
          const int* np = ptile + 3;
          pw[3] = pass / (np[1] * np[2]);
          pw[4] = (pass / np[2]) % np[1];
          pw[5] = pass % np[2];
#pragma unroll
          for (int a = 0; a < 3; ++a) pw[a] = min(ptile[a] + Ar::kW * pw[3 + a], 8);
          pw[6] = min(pw[2] & ~3, 4);
        }
        __syncthreads();
        if (pass >= ptile[6]) break;
      } else {
        if (pass > 0) break;
      }
      // counting sort of the slots by bin.  Lanes with one bin add to its
      // count once; the loop runs over whole warps, slots past the prefix in
      // the no-stencil bin
      const int len = cur[kRingLen];
      for (int q = tid; q < round_up(len, 32); q += kThreads) {
        const int b = q >= len ? Ar::kBases
                      : Ar::kWindow ? window_bin(sbin[q], ptile, pw + 3, pw) : sbin[q];
        const unsigned peers = __match_any_sync(0xffffffffu, b);
        const int leader = __ffs(peers) - 1;
        int first = 0;
        if (lane == leader) first = atomicAdd(&hist[b], __popc(peers));
        srank[q] = (unsigned short)(__shfl_sync(0xffffffffu, first, leader)
                                    + __popc(peers & ((1u << lane) - 1u)));
      }
      __syncthreads();
      scan_bins<Ar>(hist, blist, n_occ, wsum, tid);
      __syncthreads();
      for (int q = tid; q < len; q += kThreads) {
        const int b = Ar::kWindow ? window_bin(sbin[q], ptile, pw + 3, pw) : sbin[q];
        if (b < Ar::kBases) perm[hist[b] + srank[q]] = (unsigned short)q;
      }
      __syncthreads();

      // the P2G, one thread per (occupied base, channel): a base's 4
      // channels sit on adjacent lanes, so a warp's adds hit 32 distinct
      // words (distinct banks but where two bases lie a row apart)
      const int n_items = 4 * *n_occ;
      for (int it = tid; it < n_items; it += kThreads) {
        const int b = blist[it >> 2];
        p2g_base<Ar>(p, n, b, it & 3, hist[b], hist[b + 1] - hist[b], perm, sw, pg,
                     Ar::kWindow ? oarena + (pw[2] - pw[6]) : oarena, org);
      }
      __syncthreads();

      // flush the (m, mv) arena into the next pool, zeroing it for the
      // next pass; skip zero float4s and the null oct
      if constexpr (!Ar::kWindow) {
        for (int i = tid; i < 4 * 16 * kNb; i += kThreads) {
          float4* a = reinterpret_cast<float4*>(oarena + arena_off4<Ar>(i));
          const float4 val = *a;
          *a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (val.x == 0.0f && val.y == 0.0f && val.z == 0.0f && val.w == 0.0f) continue;
          const int br = nbs[(i >> 4) & (kNb - 1)];
          if ((br >> 3) == p.null_oct) continue;
          atomicAdd(reinterpret_cast<float4*>(p.next_pool + pool_off4<Ar>(i, br, 0)), val);
        }
      } else {
        // a thread per (channel, x, y) row of the window, its 3 float4s
        // of z; window cell (x, y, z) is arena cell (o + x, o + y, az + z)
        const int ch = tid >> 6, x = (tid >> 3) & 7, y = tid & 7;
        const int cx = pw[0] + x, cy = pw[1] + y, az = pw[6];
#pragma unroll
        for (int zg = 0; zg < 3; ++zg) {
          float4* a = reinterpret_cast<float4*>(oarena + ch * Ar::kChan + x * Ar::kXS
                                                + y * Ar::kYS + 4 * zg);
          const float4 val = *a;
          *a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (val.x == 0.0f && val.y == 0.0f && val.z == 0.0f && val.w == 0.0f) continue;
          const int br = window_block(nbs, cx, cy, az + 4 * zg);
          if ((br >> 3) == p.null_oct) continue;
          atomicAdd(reinterpret_cast<float4*>(
                        p.next_pool + ((size_t)(br >> 3) * 16 + ch * 4 + (cx & 3)) * 128
                        + (br & 7) * 16 + (cy & 3) * 4),
                    val);
        }
      }
      for (int i = tid; i < Ar::kBins; i += kThreads) hist[i] = 0;
    }

    // the tile's state leaves in 16-byte stores: pos, F, aux of the prefix
    // as they now stand in the stage; active as the transfer set it and pid
    // where active over the prefix, 0 and S past it
    const size_t s0 = (size_t)cur[kRingTile] * n;
    const int len4 = cur[kRingLen] >> 2;
    for (int i = tid; i < L::kPid * len4; i += kThreads) {
      const int c = i / len4, j = i - c * len4;
      float* dst = c < 3 ? p.pos_out + c * S
                 : (M::kF && c < L::kAuxo) ? p.F_out + (c - L::kFo) * S : p.aux_out;
      reinterpret_cast<float4*>(dst + s0)[j] = reinterpret_cast<const float4*>(sw + c * n)[j];
    }
    for (int j = tid; j < n4; j += kThreads) {
      const bool in = j < len4;
      const uchar4 a = in ? reinterpret_cast<const uchar4*>(sact)[j] : make_uchar4(0, 0, 0, 0);
      const int4 pv = in ? reinterpret_cast<const int4*>(spid)[j] : make_int4(0, 0, 0, 0);
      const int none = (int)S;
      reinterpret_cast<uchar4*>(p.active_out + s0)[j] = a;
      reinterpret_cast<int4*>(p.pid_out + s0)[j] =
          make_int4(a.x ? pv.x : none, a.y ? pv.y : none, a.z ? pv.z : none,
                    a.w ? pv.w : none);
    }
    // the stage is refilled by the async proxy next: order these accesses
    // first; then the tile after the next into this tile's ring slot
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    take(s);
  }
  if (tid == 0 && *streamed) atomicAdd(p.streamed, *streamed);

  // the drift margin: one atomicMax per block; the last block decodes
  const uint32_t wk = __reduce_max_sync(0xffffffffu, kmax);
  if (lane == 0 && wk) atomicMax(blk_key, wk);
  __syncthreads();
  if (tid == 0) {
    if (*blk_key) atomicMax(&p.margin_key[0], *blk_key);
    __threadfence();
    if (atomicAdd(&p.margin_key[1], 1u) == gridDim.x - 1) {
      __threadfence();
      *p.margin_out = margin_value(atomicMax(&p.margin_key[0], 0u));
    }
    // the block's balance: its live tiles, its span, its claims
    const unsigned long long live = (unsigned long long)ctl[kLive],
                             ns = global_ns() - *start;
    atomicAdd(&p.balance[0], 1ull);
    atomicAdd(&p.balance[1], live);
    atomicMax(&p.balance[2], live);
    atomicAdd(&p.balance[3], ns);
    atomicMax(&p.balance[4], ns);
    atomicAdd(&p.balance[5], (unsigned long long)ctl[kClaims]);
  }
}

// shared memory and resident blocks per SM of a variant at a tile size; a
// layout past the card's per-block limit reports 0 blocks
template <class M, class A>
cudaError_t occupancy(int tile, int* blocks_per_sm, int* smem_bytes) {
  const int bytes = layout<M, A>(tile).total;
  *smem_bytes = bytes;
  *blocks_per_sm = 0;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess || bytes > limit) return err;
  err = cudaFuncSetAttribute(g2p2g_kernel<M, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, g2p2g_kernel<M, A>,
                                                       kThreads, bytes);
}

template <class M, class A>
int launch(const float* pool_v, const int* table, const int* bcoord,
           const unsigned char* tvalid, const float* pos, const float* F,
           const float* aux, const unsigned char* active, const int* pid,
           const float* dt, const float* next_dt, float* pos_out,
           float* F_out, float* aux_out, unsigned char* active_out,
           int* pid_out, float* next_pool, unsigned int* margin_key,
           float* margin_out, unsigned int* wide_tiles, unsigned long long* streamed,
           unsigned long long* balance, int num_tiles, int tile_lo, int tile_hi, int tile,
           int g, int gzo,
           int num_oct_keys, int null_oct,
           float dx, float dx_inv, float d_inv, float mass, const float* mp, int num_mp,
           void* stream) {
  if (num_tiles <= 0 || tile_lo < 0 || tile_hi <= tile_lo || tile_hi > num_tiles
      || tile < kMinTile || tile > kMaxTile || (tile & (tile - 1))
      || num_mp < 0 || num_mp > kMaxParams)
    return (int)cudaErrorInvalidValue;
  if ((M::kF && (F == nullptr || F_out == nullptr)) ||
      (M::kAux && (aux == nullptr || aux_out == nullptr)) ||
      (A::kWindow && wide_tiles == nullptr) || streamed == nullptr || balance == nullptr)
    return (int)cudaErrorInvalidValue;
  int per_sm = 0, bytes = 0, dev = 0, sms = 0;
  cudaError_t err = occupancy<M, A>(tile, &per_sm, &bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  Params p{pool_v, table, bcoord, tvalid, pos, F, aux, active, pid, dt,
           next_dt, pos_out, F_out, aux_out, active_out, pid_out, next_pool,
           margin_key, margin_out, wide_tiles, streamed, balance, num_tiles, tile_lo, tile_hi,
           tile,
           g, gzo, num_oct_keys, null_oct, dx, dx_inv, d_inv, mass, {}};
  for (int i = 0; i < num_mp; ++i) p.mp[i] = mp[i];
  const int range = tile_hi - tile_lo;
  const int blocks = range < sms * per_sm ? range : sms * per_sm;
  g2p2g_kernel<M, A><<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <class M, class A>
int info(int tile, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, g2p2g_kernel<M, A>);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  return (int)occupancy<M, A>(tile, &out[1], &out[2]);
}

template <class M>
int info_span(int span, int tile, int* out) {
  if (span == 2) return info<M, Span2>(tile, out);
  if (span == 4) return info<M, Span4>(tile, out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// one C entry per material, all with the same arguments; F/aux and their
// outputs are null where the material has no such field; ``span`` is the
// arena span, 2 or 4; only the tiles of [tile_lo, tile_hi) are transferred
// and only their slots of the outputs written (position and fields over
// each tile's occupied prefix); ``streamed`` (u64[1]) gains the slots of
// the occupied prefixes
#define CM_G2P2G_ENTRY(NAME, MAT)                                              \
  extern "C" int NAME(                                                         \
      const float* pool_v, const int* table, const int* bcoord,                \
      const unsigned char* tvalid, const float* pos, const float* F,           \
      const float* aux, const unsigned char* active, const int* pid,           \
      const float* dt, const float* next_dt, float* pos_out, float* F_out,     \
      float* aux_out, unsigned char* active_out, int* pid_out,                 \
      float* next_pool, unsigned int* margin_key, float* margin_out,           \
      unsigned int* wide_tiles, unsigned long long* streamed,                  \
      unsigned long long* balance, int num_tiles,                              \
      int tile_lo, int tile_hi, int tile, int span, int g, int gzo,            \
      int num_oct_keys, int null_oct,                                          \
      float dx, float dx_inv, float d_inv, float mass, const float* mp,        \
      int num_mp, void* stream) {                                              \
    if (span == 2)                                                             \
      return launch<MAT, Span2>(pool_v, table, bcoord, tvalid, pos, F, aux,    \
                                active, pid, dt, next_dt, pos_out, F_out,      \
                                aux_out, active_out, pid_out, next_pool,       \
                                margin_key, margin_out, wide_tiles, streamed,  \
                                balance, num_tiles, tile_lo, tile_hi, tile, g, \
                                gzo, num_oct_keys, null_oct, dx, dx_inv,       \
                                d_inv, mass, mp, num_mp, stream);              \
    if (span == 4)                                                             \
      return launch<MAT, Span4>(pool_v, table, bcoord, tvalid, pos, F, aux,    \
                                active, pid, dt, next_dt, pos_out, F_out,      \
                                aux_out, active_out, pid_out, next_pool,       \
                                margin_key, margin_out, wide_tiles, streamed,  \
                                balance, num_tiles, tile_lo, tile_hi, tile, g, \
                                gzo, num_oct_keys, null_oct, dx, dx_inv,       \
                                d_inv, mass, mp, num_mp, stream);              \
    return (int)cudaErrorInvalidValue;                                         \
  }

CM_G2P2G_ENTRY(cm_g2p2g_fixed_corotated, FixedCorotated)
CM_G2P2G_ENTRY(cm_g2p2g_jfluid, JFluid)
CM_G2P2G_ENTRY(cm_g2p2g_sand, Sand)
CM_G2P2G_ENTRY(cm_g2p2g_nacc, NACC)

// registers, blocks per SM and dynamic shared memory of a variant at an
// arena span and a tile size: out i32[3]; variant 0 FixedCorotated, 1
// JFluid, 2 Sand, 3 NACC.  0 blocks per SM: the layout does not fit
extern "C" int cm_g2p2g_info(int variant, int span, int tile, int* out) {
  switch (variant) {
    case 0: return info_span<FixedCorotated>(span, tile, out);
    case 1: return info_span<JFluid>(span, tile, out);
    case 2: return info_span<Sand>(span, tile, out);
    case 3: return info_span<NACC>(span, tile, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
