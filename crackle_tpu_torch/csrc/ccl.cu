// Kernels 4, 5 and 6: per-slice 4-connected CCL with first-visit
// numbering, the min-index image, and the plant from sorted roots.
//
// ccl_paint replaces ccl_pallas._ccl_kernel and ccl_pallas.
// _ccl_paint_kernel (both through _ccl_core). The TPU converges labels
// by repeated row/column min sweeps; here a union-find whose every link
// points to the smaller index (union by min, Playne & Hawick, arXiv
// 1708.08180) makes each component's root its minimum raster index
// directly. A raster-order block scan over the roots then gives the
// first-visit rank, cc = rank[root], N = roots, and for K in {1, 2} the
// paint painted[ch] = T[ch, cc] where cc < cap_n, else 0.
//
// ccl_min replaces ccl_pallas._ccl_min_kernel: the same union-find and
// root scan, stopped before the renumber. It writes the min-index image
// L and tgt = first-visit rank at roots, -1 elsewhere.
//
// plant replaces ccl_pallas._plant_kernel: cc[p] = k and painted[ch, p]
// = T[ch, k] where roots[k] == L[p], else 0. The TPU walked 64-row
// stripes and bounded each stripe's rank window by a binary search of
// the stripe's min/max id in SMEM. Here a block stages its slice's
// roots and T (at most 3 x 2048 ints, 24 KB) in shared memory and every
// pixel does its own branchless lower_bound there, so no window is
// needed.
//
// What bounds them on this card: ccl_paint and ccl_min run one block
// per slice that walks sx*sy pixels (262144 at 512^2) through the
// union-find forest in device memory (L2-resident for a slice), so they
// are latency-bound on dependent loads of parents. The design links
// with atomicMin (no locks), compresses every path once after the
// unions, and reads parents with ld.cg so the SM's L1 never serves a
// stale parent written by an atomic. plant is bound by device memory:
// it reads L once and writes (1 + K) ints a pixel; its search is
// log2(cap_n) shared-memory loads a pixel, and many blocks per slice
// keep every SM busy.
#include "common.cuh"

using namespace ckl;

namespace {

constexpr int CCL_THREADS = 1024;
constexpr int PLANT_THREADS = 256;
constexpr int PLANT_PIX = 4096;  // pixels a plant block covers

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

// Union-find by min over one slice's VCG: afterwards L[p] is the least
// raster index of p's component. Every thread of the block calls it.
__device__ void converge(const int* v, int* L, int sx, int n) {
  for (int p = threadIdx.x; p < n; p += blockDim.x) L[p] = p;
  __syncthreads();
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int w = v[p];
    const int y = p / sx;
    const int x = p - y * sx;
    if (x > 0 && (w & 0b0010)) unite(L, p, p - 1);
    if (y > 0 && (w & 0b1000)) unite(L, p, p - sx);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n; p += blockDim.x) L[p] = find_root(L, p);
  __syncthreads();
}

// Raster-order rank of the roots (L[p] == p) by a block scan: calls
// emit(p, rank) for every pixel, rank -1 where p is not a root, and
// returns the number of roots. Every thread of the block calls it.
template <class Emit>
__device__ int rank_roots(const int* L, int n, int* warp, Emit emit) {
  int carry = 0;
  for (int t0 = 0; t0 < n; t0 += blockDim.x) {
    const int p = t0 + threadIdx.x;
    const int root = p < n && __ldcg(&L[p]) == p;
    int tot;
    const int incl = block_scan(root, 0, Add(), warp, &tot);
    if (p < n) emit(p, root ? carry + incl - 1 : -1);
    carry += tot;
  }
  return carry;
}

__global__ void ccl_paint_kernel(const int* __restrict__ vcg,
                                 const int* __restrict__ T,
                                 int* __restrict__ Lbuf, int* __restrict__ cc,
                                 int* __restrict__ N,
                                 int* __restrict__ painted, int sx, int sy,
                                 int K, int cap_n) {
  __shared__ int warp[MAX_WARPS];
  const int b = blockIdx.x;
  const int n = sx * sy;
  int* L = Lbuf + (size_t)b * n;
  int* out = cc + (size_t)b * n;

  converge(vcg + (size_t)b * n, L, sx, n);
  const int roots = rank_roots(L, n, warp, [&](int p, int rank) {
    if (rank >= 0) out[p] = rank;
  });
  if (threadIdx.x == 0) N[b] = roots;
  __syncthreads();

  for (int p = threadIdx.x; p < n; p += blockDim.x) {
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

__global__ void ccl_min_kernel(const int* __restrict__ vcg,
                               int* __restrict__ Lbuf,
                               int* __restrict__ tgt, int sx, int sy) {
  __shared__ int warp[MAX_WARPS];
  const int b = blockIdx.x;
  const int n = sx * sy;
  int* L = Lbuf + (size_t)b * n;
  int* t = tgt + (size_t)b * n;

  converge(vcg + (size_t)b * n, L, sx, n);
  rank_roots(L, n, warp, [&](int p, int rank) { t[p] = rank; });
}

// First i in [0, len) with s[i] >= x, or len; s sorted, len >= 1.
__device__ __forceinline__ int lower_bound(const int* s, int len, int x) {
  int base = 0;
  while (len > 1) {
    const int half = len >> 1;
    base = s[base + half] < x ? base + half : base;
    len -= half;
  }
  return base + (s[base] < x);
}

// grid (ceil(n / PLANT_PIX), B); dynamic shared (1 + K) * cap_n ints
__global__ void plant_kernel(const int* __restrict__ L,
                             const int* __restrict__ roots,
                             const int* __restrict__ T, int* __restrict__ cc,
                             int* __restrict__ painted, int n, int K,
                             int cap_n) {
  extern __shared__ int tables[];
  int* r = tables;
  int* t = tables + cap_n;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < cap_n; i += blockDim.x)
    r[i] = roots[(size_t)b * cap_n + i];
  for (int i = threadIdx.x; i < K * cap_n; i += blockDim.x)
    t[i] = T[(size_t)b * K * cap_n + i];
  __syncthreads();

  const int p0 = blockIdx.x * PLANT_PIX;
  const int p1 = min(p0 + PLANT_PIX, n);
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    const int l = L[(size_t)b * n + p];
    const int k = lower_bound(r, cap_n, l);
    // roots are padded with n, which no pixel's id may match
    const bool hit = l >= 0 && l < n && k < cap_n && r[k] == l;
    cc[(size_t)b * n + p] = hit ? k : 0;
    for (int ch = 0; ch < K; ++ch)
      painted[((size_t)b * K + ch) * n + p] = hit ? t[ch * cap_n + k] : 0;
  }
}

}  // namespace

extern "C" int ccl_paint_launch(const void* vcg, const void* T, void* L,
                                void* cc, void* N, void* painted, int B,
                                int sx, int sy, int K, int cap_n,
                                void* stream) {
  ccl_paint_kernel<<<B, CCL_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)vcg, (const int*)T, (int*)L, (int*)cc, (int*)N,
      (int*)painted, sx, sy, K, cap_n);
  return (int)cudaGetLastError();
}

extern "C" int ccl_min_launch(const void* vcg, void* L, void* tgt, int B,
                              int sx, int sy, void* stream) {
  ccl_min_kernel<<<B, CCL_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)vcg, (int*)L, (int*)tgt, sx, sy);
  return (int)cudaGetLastError();
}

extern "C" int plant_launch(const void* L, const void* roots, const void* T,
                            void* cc, void* painted, int B, int n, int K,
                            int cap_n, void* stream) {
  const dim3 grid((n + PLANT_PIX - 1) / PLANT_PIX, B);
  const size_t smem = (size_t)(1 + K) * cap_n * sizeof(int);
  plant_kernel<<<grid, PLANT_THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)L, (const int*)roots, (const int*)T, (int*)cc,
      (int*)painted, n, K, cap_n);
  return (int)cudaGetLastError();
}
