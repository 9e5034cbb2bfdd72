// Shared device helpers for the crackle_tpu_torch kernels.
#pragma once
#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace ckl {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_WARPS = 32;  // blockDim.x <= 1024

struct Add {
  template <class T> __device__ T operator()(T a, T b) const { return a + b; }
};
struct Min {
  template <class T> __device__ T operator()(T a, T b) const { return a < b ? a : b; }
};
struct Max {
  template <class T> __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};
// Later-set-wins: b if set (>= 0) else a. Associative with unit -1.
struct LastSet {
  template <class T> __device__ T operator()(T a, T b) const { return b >= 0 ? b : a; }
};

// Inclusive scan over the block in thread order, op(earlier, later).
// blockDim.x must be a multiple of 32. `warp` is MAX_WARPS elements of
// shared scratch; `total` (optional) receives the scan of the whole
// block. Every thread of the block must call it (it holds barriers).
template <class T, class Op>
__device__ T block_scan(T v, T unit, Op op, T* warp, T* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T n = __shfl_up_sync(FULL_MASK, v, o);
    if (lane >= o) v = op(n, v);
  }
  if (lane == 31) warp[wid] = v;
  __syncthreads();
  if (wid == 0) {
    T w = lane < nw ? warp[lane] : unit;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T n = __shfl_up_sync(FULL_MASK, w, o);
      if (lane >= o) w = op(n, w);
    }
    if (lane < nw) warp[lane] = w;
  }
  __syncthreads();
  if (wid > 0) v = op(warp[wid - 1], v);
  if (total) *total = warp[nw - 1];
  __syncthreads();  // warp[] is reused by the next scan
  return v;
}

// Exclusive scan over the block in thread order: thread t gets the scan
// of threads [0, t) (`unit` for thread 0), and `total` (optional) that
// of the whole block. Same rules as block_scan.
template <class T, class Op>
__device__ T block_scan_excl(T v, T unit, Op op, T* warp, T* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T n = __shfl_up_sync(FULL_MASK, v, o);
    if (lane >= o) v = op(n, v);
  }
  T ex = __shfl_up_sync(FULL_MASK, v, 1);
  if (lane == 31) warp[wid] = v;
  __syncthreads();
  if (wid == 0) {
    T w = lane < nw ? warp[lane] : unit;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T n = __shfl_up_sync(FULL_MASK, w, o);
      if (lane >= o) w = op(n, w);
    }
    if (lane < nw) warp[lane] = w;
  }
  __syncthreads();
  const T pre = wid > 0 ? warp[wid - 1] : unit;
  ex = lane == 0 ? pre : op(pre, ex);
  if (total) *total = warp[nw - 1];
  __syncthreads();  // warp[] is reused by the next scan
  return ex;
}

// out[tid] = v[tid - 1]; thread 0 gets `carry`. `buf` is blockDim.x
// elements of shared scratch; every thread of the block must call it.
__device__ __forceinline__ int shift_prev(int v, int carry, int* buf) {
  buf[threadIdx.x] = v;
  __syncthreads();
  int p = threadIdx.x ? buf[threadIdx.x - 1] : carry;
  __syncthreads();
  return p;
}

// floor(a / d) for d > 0 (C's / truncates toward zero)
__device__ __forceinline__ long long floor_div(long long a, long long d) {
  long long q = a / d;
  return (a % d != 0 && a < 0) ? q - 1 : q;
}

}  // namespace ckl
