// Block-wide scans shared by the rebucket (rebucket.cu) and the partition
// rebuild (partition.cu): a warp's inclusive scan by shuffles, a block's
// exclusive scan through one shared word per warp, and one block's scan of
// a short array (each thread a contiguous run).
#pragma once

#include <cuda_runtime.h>

namespace cm_scan {

template <typename T>
__device__ __forceinline__ T warp_inclusive(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Exclusive scan of v over the block (blockDim.x a multiple of 32); *total
// gets the block's sum.  Every thread of the block must call it.
template <typename T>
__device__ T block_exclusive(T v, T* total) {
  __shared__ T warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const T inc = warp_inclusive(v);
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const T w = warp_inclusive(lane < nw ? warp_sums[lane] : T(0));
    warp_sums[lane] = w;
  }
  __syncthreads();
  const T before = warp == 0 ? T(0) : warp_sums[warp - 1];
  *total = warp_sums[nw - 1];
  __syncthreads();                             // warp_sums is reused by the next call
  return before + inc - v;
}

// One block: out = exclusive scan of in[0, n); returns the total.  Each
// thread takes a contiguous run of the values.
template <typename T>
__device__ T scan_serial(const T* __restrict__ in, int n, T* __restrict__ out) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  T s = 0;
  for (int i = lo; i < hi; ++i) s += in[i];
  T total;
  T run = block_exclusive(s, &total);
  for (int i = lo; i < hi; ++i) {
    const T v = in[i];
    out[i] = run;
    run += v;
  }
  return total;
}

}  // namespace cm_scan
