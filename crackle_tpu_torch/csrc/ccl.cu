// Kernel 4. 4-connected CCL with first-visit numbering and label paint.
//
// Replaces ccl_pallas._ccl_kernel and ccl_pallas._ccl_paint_kernel
// (both through _ccl_core). The TPU converges labels by repeated
// row/column min sweeps; here a union-find whose every link points to
// the smaller index (union by min, Playne & Hawick, arXiv 1708.08180)
// makes each component's root its minimum raster index directly.
// A raster-order block scan over the roots then gives the first-visit
// rank, cc = rank[root], N = roots, and for K in {1, 2} the paint
// painted[ch] = T[ch, cc] where cc < cap_n, else 0.
//
// What bounds it on this card: one block per slice walks sx*sy pixels
// (262144 at 512^2) through the union-find forest in device memory
// (L2-resident for a slice), so it is latency-bound on dependent loads
// of parents. The design links with atomicMin (no locks), compresses
// every path once after the unions, and reads parents with ld.cg so the
// SM's L1 never serves a stale parent written by an atomic.
#include "common.cuh"

using namespace ckl;

namespace {

__device__ __forceinline__ int find_root(const int* L, int p) {
  int q = __ldcg(&L[p]);
  while (q != p) {
    p = q;
    q = __ldcg(&L[p]);
  }
  return p;
}

__device__ __forceinline__ void unite(int* L, int a, int b) {
  bool done;
  do {
    a = find_root(L, a);
    b = find_root(L, b);
    if (a < b) {
      const int old = atomicMin(&L[b], a);
      done = old == b;
      b = old;
    } else if (b < a) {
      const int old = atomicMin(&L[a], b);
      done = old == a;
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

__global__ void ccl_paint_kernel(const int* __restrict__ vcg,
                                 const int* __restrict__ T,
                                 int* __restrict__ Lbuf, int* __restrict__ cc,
                                 int* __restrict__ N,
                                 int* __restrict__ painted, int sx, int sy,
                                 int K, int cap_n) {
  __shared__ int warp[MAX_WARPS];
  const int b = blockIdx.x;
  const int nt = blockDim.x;
  const int n = sx * sy;
  const int* v = vcg + (size_t)b * n;
  int* L = Lbuf + (size_t)b * n;
  int* out = cc + (size_t)b * n;

  for (int p = threadIdx.x; p < n; p += nt) L[p] = p;
  __syncthreads();
  for (int p = threadIdx.x; p < n; p += nt) {
    const int w = v[p];
    const int y = p / sx;
    const int x = p - y * sx;
    if (x > 0 && (w & 0b0010)) unite(L, p, p - 1);
    if (y > 0 && (w & 0b1000)) unite(L, p, p - sx);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n; p += nt) L[p] = find_root(L, p);
  __syncthreads();

  // raster-order rank of the roots (component minima)
  int carry = 0;
  for (int t0 = 0; t0 < n; t0 += nt) {
    const int p = t0 + threadIdx.x;
    const int root = p < n && __ldcg(&L[p]) == p;
    int tot;
    const int incl = block_scan(root, 0, Add(), warp, &tot);
    if (root) out[p] = carry + incl - 1;
    carry += tot;
  }
  if (threadIdx.x == 0) N[b] = carry;
  __syncthreads();

  for (int p = threadIdx.x; p < n; p += nt) {
    const int r = __ldcg(&L[p]);
    int c;
    if (r == p) {
      c = out[p];
    } else {
      c = __ldcg(&out[r]);
      out[p] = c;
    }
    for (int ch = 0; ch < K; ++ch) {
      painted[((size_t)b * K + ch) * n + p] =
          c < cap_n ? T[((size_t)b * K + ch) * cap_n + c] : 0;
    }
  }
}

}  // namespace

extern "C" int ccl_paint_launch(const void* vcg, const void* T, void* L,
                                void* cc, void* N, void* painted, int B,
                                int sx, int sy, int K, int cap_n,
                                void* stream) {
  ccl_paint_kernel<<<B, 1024, 0, (cudaStream_t)stream>>>(
      (const int*)vcg, (const int*)T, (int*)L, (int*)cc, (int*)N,
      (int*)painted, sx, sy, K, cap_n);
  return (int)cudaGetLastError();
}
