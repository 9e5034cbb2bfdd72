// Kernels 4, 5 and 6: per-slice 4-connected CCL with first-visit
// numbering, the min-index image, and the plant from sorted roots.
//
// ccl_paint replaces ccl_pallas._ccl_kernel and ccl_pallas.
// _ccl_paint_kernel (both through _ccl_core). The TPU converges labels
// by repeated row/column segmented-min sweeps over a slice held in
// VMEM, ranks the roots by a raster-order 2-D prefix sum and sweeps the
// ranks out again. Here a union-find whose every link points to the
// smaller index (union by min, Playne & Hawick, arXiv 1708.08180) makes
// each component's root its least raster index whatever the order of
// the atomics, so the first-visit rank is the raster rank of the roots:
// cc = rank[root], N = roots, and for K in {1, 2} painted[ch] =
// T[ch, cc] where cc < cap_n, else 0.
//
// ccl_min replaces ccl_pallas._ccl_min_kernel: the same union-find and
// root rank, stopped before the renumber. It writes the min-index image
// L and tgt = first-visit rank at roots, -1 elsewhere. ccl_min_roots
// runs the same passes but writes, in place of tgt, what ccl_pallas.
// roots_from_tgt makes of it: each slice's roots in rank order (its
// sorted component minima) and their count N.
//
// The design: a slice is cut into tiles of `tile` consecutive raster
// pixels (ccl.TILE_PIX, a power of two; a row may split across tiles),
// and every pass runs on a grid of (tiles, B) blocks, one kernel each:
//   ccl_local  the tile's parents live in shared memory. Left links
//              take no union: each pixel points at the start of its run
//              along the row. Up links are united by min with shared
//              atomicMin, except where the left links of both rows and
//              the neighbour's up link imply them (then only the first
//              pixel of each run that two rows share unites), from a
//              list so that no lane idles its warp; then L[p] = the
//              global index of p's local root;
//   ccl_merge  the links that leave the tile (the up links of its first
//              min(sx, tile) pixels, with the same skip, and the left
//              link of its first pixel) united in device memory with
//              the same lock-free union;
//   ccl_count  roots per tile: p is a root exactly when L[p] == p (a
//              non-root points below itself, and the merge only lowers
//              roots), so no find is needed;
//   ccl_rank   each block sums the counts of the tiles before it, then
//              ranks its roots by a block scan: cc at roots (ccl_paint)
//              or tgt, and L[p] = find(p) (ccl_min), or roots[rank] = p
//              and L[p] = find(p) (ccl_min_roots); N from the last
//              tile, which also pads the roots past N;
//   ccl_fill   (ccl_paint) cc[p] = cc[find(L[p])] and the paint, with
//              T staged in shared memory.
//
// What bounds them on this card: bytes, once the finds stay in shared
// memory. The passes read and write about 30-40 bytes a pixel. The
// one-block-per-slice design this replaces kept the forest in device
// memory on the claim that it was L2-resident for a slice; at B = 512
// two 1024-thread blocks per SM put 264 slices in flight, 264 MB of
// parents against the 50 MB L2, so every dependent find went to DRAM,
// and at B = 32 only 32 of the 132 SMs worked. Shared-memory parents
// are read through volatile loads so the compiler keeps none in a
// register across an atomic; in the merge, device-memory parents are
// read with ld.cg so the SM's L1 never serves one that an atomic has
// since lowered (after it, roots stay put and cached loads serve).
//
// plant replaces ccl_pallas._plant_kernel: cc[p] = k and painted[ch, p]
// = T[ch, k] where roots[k] == L[p], else 0. The TPU walked 64-row
// stripes and bounded each stripe's rank window by a binary search of
// the stripe's min/max id in SMEM. Here no pixel searches: plant_map
// writes each root's rank into a dense root -> k map of the slice
// (cap_n stores), and plant_kernel reads the map at L[p], one gather a
// pixel, and checks the entry against the roots, so the map needs no
// fill (an entry no root wrote may hold anything, and no root equals
// its id). Nothing is staged in shared memory, so cap_n has no limit
// and no block reloads a table; roots, T and the few map lines a slice
// reads stay in L1 and L2. plant is bound by device memory: it reads L
// once and writes (1 + K) ints a pixel, 16 bytes a load and a store.
#include "common.cuh"

using namespace ckl;

namespace {

constexpr int CCL_MAX_THREADS = 1024;
constexpr int MERGE_THREADS = 256;
constexpr int PLANT_THREADS = 256;

// Threads of a tiled block: four pixels each, at least a warp.
inline int tile_threads(int tile) {
  const int t = tile / 4;
  return t < 32 ? 32 : (t > CCL_MAX_THREADS ? CCL_MAX_THREADS : t);
}

// v[k] = a[i + k] for i + k < len, else `fill`; one 16-byte load where
// the four lie in range and aligned.
__device__ __forceinline__ void load4(const int* a, int i, int len, int v[4],
                                      int fill) {
  if (i + 4 <= len && !(reinterpret_cast<uintptr_t>(a + i) & 15)) {
    const int4 q = *reinterpret_cast<const int4*>(a + i);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i + k < len ? a[i + k] : fill;
  }
}

// a[i + k] = v[k] for i + k < len; one 16-byte store where it can.
__device__ __forceinline__ void store4(int* a, int i, int len,
                                       const int v[4]) {
  if (i + 4 <= len && !(reinterpret_cast<uintptr_t>(a + i) & 15)) {
    *reinterpret_cast<int4*>(a + i) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i + k < len) a[i + k] = v[k];
  }
}

// --- union by min over a forest of parents ----------------------------
//
// SHARED: one tile's forest in shared memory, read through volatile
// loads. Else one slice's forest in device memory during the merge, read
// with ld.cg so the SM's L1 never serves a parent an atomic has since
// lowered.

template <bool SHARED>
__device__ __forceinline__ int parent(const int* s, int p) {
  if constexpr (SHARED) return *reinterpret_cast<const volatile int*>(s + p);
  else return __ldcg(s + p);
}

template <bool SHARED>
__device__ __forceinline__ int find(const int* s, int p) {
  int q = parent<SHARED>(s, p);
  while (q != p) {
    p = q;
    q = parent<SHARED>(s, p);
  }
  return p;
}

template <bool SHARED>
__device__ __forceinline__ void unite(int* s, int a, int b) {
  while (true) {
    a = find<SHARED>(s, a);
    b = find<SHARED>(s, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(&s[b], a);  // link b -> a unless b moved
    if (old == b) return;
    b = old;
  }
}

// The walk through cached loads, for the passes after the merge: roots
// no longer move there, so an entry an L1 line holds stale still points
// to an ancestor.
__device__ __forceinline__ int find_settled(const int* L, int p) {
  int q = L[p];
  while (q != p) {
    p = q;
    q = L[p];
  }
  return p;
}

// True where the up link of j is implied by links that are united
// elsewhere: j ~ j - 1 (left), j - 1 ~ j - 1 - sx (up) and j - sx ~
// j - sx - 1 (left) make j ~ j - sx, so only the first pixel of each
// run of up links that two rows share needs a union. `w` are j's bits,
// `wl` j - 1's, `wu` j - sx's; the caller checks that j is not in
// column 0 and that j - 1 has an up neighbour.
__device__ __forceinline__ bool up_implied(int w, int wl, int wu) {
  return (w & 0b0010) && (wl & 0b1000) && (wu & 0b0010);
}

// grid (tiles, B); dynamic shared 8 * tile bytes: the parents,
// then two lists of 16-bit local indices. L[p] = the global index of
// p's root among the links inside p's tile.
//
// Left links need no union: a pixel's parent starts as the start of its
// run along the row. One sweep reads the VCG and lists, in raster order
// (an add-scan of the two counts packed in one int), the run starts and
// the up links that up_implied does not cover; a pixel before its
// thread's first run start takes the start listed just before. Then the
// listed up links are united (they link run starts only), every run
// start is pointed at its root, and each pixel's root is two loads
// away. Working from lists keeps every lane busy: a lane with a union
// or a find does not hold its warp's other 31.
__global__ void __launch_bounds__(CCL_MAX_THREADS)
ccl_local_kernel(const int* __restrict__ vcg, int* __restrict__ Lbuf, int sx,
                 int n, int tile) {
  extern __shared__ int par[];
  __shared__ int warp[MAX_WARPS];
  unsigned short* ups = reinterpret_cast<unsigned short*>(par + tile);
  unsigned short* starts = ups + tile;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * tile;
  const int len = min(tile, n - p0);
  const int* v = vcg + (size_t)b * n + p0;
  int* L = Lbuf + (size_t)b * n + p0;
  const int step = blockDim.x * 4;

  int n_ups = 0, n_starts = 0;  // listed by the chunks before
  for (int i0 = 0; i0 < len; i0 += step) {
    const int i = i0 + threadIdx.x * 4;
    int w[4], wu[4];
    load4(v, i, len, w, 0);
    if (i >= sx) {
      load4(v, i - sx, len, wu, 0);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wu[k] = i + k >= sx && i + k < len ? v[i + k - sx] : 0;
    }
    int wl = i > 0 && i < len ? v[i - 1] : 0;
    int x = (p0 + i) % sx;
    int st[4], c = 0;
    bool up[4], start[4];
#pragma unroll
    for (int k = 0; k < 4; ++k, ++x) {
      if (x == sx) x = 0;
      const int j = i + k;
      start[k] = j < len && !(j > 0 && x > 0 && (w[k] & 0b0010));
      up[k] = j < len && j >= sx && (w[k] & 0b1000) &&
              !(j > sx && x > 0 && up_implied(w[k], wl, wu[k]));
      c += up[k] + (start[k] << 16);
      wl = w[k];
    }
    int tot;
    const int before = block_scan(c, 0, Add(), warp, &tot) - c;
    int u = n_ups + (before & 0xffff), t = n_starts + (before >> 16);
    int last = -1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (up[k]) ups[u++] = (unsigned short)(i + k);
      if (start[k]) starts[t++] = (unsigned short)(last = i + k);
      st[k] = last;
    }
    __syncthreads();  // the start before this thread's first is listed
    const int prev = n_starts + (before >> 16) - 1;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i + k < len) par[i + k] = st[k] >= 0 ? st[k] : starts[prev];
    n_ups += tot & 0xffff;
    n_starts += tot >> 16;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_ups; e += blockDim.x) {
    const int j = ups[e];
    unite<true>(par, j, j - sx);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_starts; e += blockDim.x) {
    const int j = starts[e];
    par[j] = find<true>(par, j);
  }
  __syncthreads();
  for (int i = threadIdx.x * 4; i < len; i += step) {
    int r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = i + k < len ? p0 + par[par[i + k]] : 0;
    store4(L, i, len, r);
  }
}

// grid (tiles, B), MERGE_THREADS. Unites, in device memory, the links
// that leave each tile: the up links of its first min(sx, tile) pixels
// and the left link of its first pixel.
__global__ void __launch_bounds__(MERGE_THREADS)
ccl_merge_kernel(const int* __restrict__ vcg, int* __restrict__ Lbuf, int sx,
                 int n, int tile) {
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * tile;
  const int len = min(min(tile, n - p0), sx);
  const int* v = vcg + (size_t)b * n;
  int* L = Lbuf + (size_t)b * n;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int p = p0 + i;
    const int w = v[p];
    const int x = p % sx;
    // up_implied leans on p - 1's up link, which this pass unites too
    if (p >= sx && (w & 0b1000) &&
        !(i > 0 && x > 0 && p > sx && up_implied(w, v[p - 1], v[p - sx])))
      unite<false>(L, p, p - sx);
    if (i == 0 && x != 0 && (w & 0b0010)) unite<false>(L, p, p - 1);
  }
}

// grid (tiles, B). counts[b, t] = the roots (L[p] == p) of tile t.
__global__ void __launch_bounds__(CCL_MAX_THREADS)
ccl_count_kernel(const int* __restrict__ Lbuf, int* __restrict__ counts,
                 int n, int tile) {
  __shared__ int warp[MAX_WARPS];
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * tile;
  const int len = min(tile, n - p0);
  const int* L = Lbuf + (size_t)b * n + p0;
  int c = 0;
  for (int i = threadIdx.x * 4; i < len; i += blockDim.x * 4) {
    int l[4];
    load4(L, i, len, l, -1);
#pragma unroll
    for (int k = 0; k < 4; ++k) c += l[k] == p0 + i + k;
  }
  int tot;
  block_scan(c, 0, Add(), warp, &tot);
  if (threadIdx.x == 0) counts[(size_t)b * gridDim.x + blockIdx.x] = tot;
}

// What the rank pass writes besides N: cc at the roots (ccl_paint), tgt
// and L = find (ccl_min), or the roots and L = find (ccl_min_roots).
enum RankOut { RANK_CC, RANK_TGT, RANK_ROOTS };

// grid (tiles, B). The raster rank of each root: the roots of the
// earlier tiles (from counts) plus a block scan inside the tile.
// RANK_CC: out[p] = rank at roots only. RANK_TGT: out[p] = rank at
// roots, -1 elsewhere, and L[p] = find(p). RANK_ROOTS: out is (B, cap):
// out[b, rank] = p at each root whose rank is below cap (the rest are
// dropped), L[p] = find(p), and the slice's last tile pads out[b, N..cap)
// with n; ranks are dense, so every entry is written once. N[b] (when
// given) is the slice's root count.
template <RankOut OUT>
__device__ __forceinline__ void rank_tile(int* __restrict__ Lbuf,
                                          const int* __restrict__ counts,
                                          int* __restrict__ out,
                                          int* __restrict__ N, int n,
                                          int tile, int cap) {
  __shared__ int warp[MAX_WARPS];
  const int b = blockIdx.y;
  const int t = blockIdx.x;
  const int p0 = t * tile;
  const int len = min(tile, n - p0);
  int* Ls = Lbuf + (size_t)b * n;
  int* L = Ls + p0;
  int* o = OUT == RANK_ROOTS ? out + (size_t)b * cap
                              : out + (size_t)b * n + p0;

  int before = 0;
  for (int j = threadIdx.x; j < t; j += blockDim.x)
    before += counts[(size_t)b * gridDim.x + j];
  int carry;
  block_scan(before, 0, Add(), warp, &carry);

  for (int i0 = 0; i0 < len; i0 += blockDim.x * 4) {
    const int i = i0 + threadIdx.x * 4;
    int l[4];
    load4(L, i, len, l, -1);
    int c = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) c += l[k] == p0 + i + k;
    int tot;
    int r = carry + block_scan(c, 0, Add(), warp, &tot) - c;
    if (OUT == RANK_CC) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (l[k] == p0 + i + k) o[i + k] = r++;
    } else {
      int tg[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool root = l[k] == p0 + i + k;
        if (OUT == RANK_TGT) {
          tg[k] = root ? r++ : -1;
        } else if (root) {
          if (r < cap) o[r] = p0 + i + k;
          ++r;
        }
        if (!root && i + k < len) l[k] = find_settled(Ls, l[k]);
      }
      if (OUT == RANK_TGT) store4(o, i, len, tg);
      store4(L, i, len, l);
    }
    carry += tot;
  }
  if (t == gridDim.x - 1) {
    if (N && threadIdx.x == 0) N[b] = carry;
    if (OUT == RANK_ROOTS)
      for (int r = carry + threadIdx.x; r < cap; r += blockDim.x) o[r] = n;
  }
}

// ccl_paint (MIN false) and ccl_min (MIN true): rank_tile's RANK_CC and
// RANK_TGT.
template <bool MIN>
__global__ void __launch_bounds__(CCL_MAX_THREADS)
ccl_rank_kernel(int* __restrict__ Lbuf, const int* __restrict__ counts,
                int* __restrict__ out, int* __restrict__ N, int n,
                int tile) {
  rank_tile<MIN ? RANK_TGT : RANK_CC>(Lbuf, counts, out, N, n, tile, 0);
}

// ccl_min_roots: rank_tile's RANK_ROOTS into roots (B, cap).
__global__ void __launch_bounds__(CCL_MAX_THREADS)
ccl_rank_kernel(int* __restrict__ Lbuf, const int* __restrict__ counts,
                int* __restrict__ roots, int* __restrict__ N, int n,
                int tile, int cap) {
  rank_tile<RANK_ROOTS>(Lbuf, counts, roots, N, n, tile, cap);
}

// grid (tiles, B); dynamic shared K * cap_n ints. cc[p] = cc[root of
// p] and painted[ch, p] = T[ch, cc[p]] where cc[p] < cap_n, else 0.
__global__ void __launch_bounds__(CCL_MAX_THREADS)
ccl_fill_kernel(const int* __restrict__ Lbuf, const int* __restrict__ T,
                int* __restrict__ cc, int* __restrict__ painted, int n, int K,
                int cap_n, int tile) {
  extern __shared__ int tab[];
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * tile;
  const int len = min(tile, n - p0);
  const int* Ls = Lbuf + (size_t)b * n;
  int* ccs = cc + (size_t)b * n;
  for (int i = threadIdx.x; i < K * cap_n; i += blockDim.x)
    tab[i] = T[(size_t)b * K * cap_n + i];
  __syncthreads();

  for (int i = threadIdx.x * 4; i < len; i += blockDim.x * 4) {
    int l[4], c[4];
    load4(Ls + p0, i, len, l, -1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = p0 + i + k;
      if (i + k >= len) {
        c[k] = 0;
      } else if (l[k] == p) {
        c[k] = ccs[p];
      } else {
        c[k] = ccs[find_settled(Ls, l[k])];
      }
    }
    store4(ccs + p0, i, len, c);
    for (int ch = 0; ch < K; ++ch) {
      int pv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        pv[k] = c[k] < cap_n ? tab[ch * cap_n + c[k]] : 0;
      store4(painted + ((size_t)b * K + ch) * n + p0, i, len, pv);
    }
  }
}

// ccl_local, ccl_merge then ccl_count on grid (tiles, B); returns the
// first error.
int converge_launch(const int* vcg, int* L, int* counts, int B, int sx,
                    int n, int tile, cudaStream_t stream) {
  const dim3 grid((n + tile - 1) / tile, B);
  const int smem = tile * 8;  // int parents, two ushort lists
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        ccl_local_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  ccl_local_kernel<<<grid, tile_threads(tile), smem, stream>>>(vcg, L, sx, n,
                                                                tile);
  int err = (int)cudaGetLastError();
  if (err) return err;
  ccl_merge_kernel<<<grid, MERGE_THREADS, 0, stream>>>(vcg, L, sx, n, tile);
  if ((err = (int)cudaGetLastError())) return err;
  ccl_count_kernel<<<grid, tile_threads(tile), 0, stream>>>(L, counts, n,
                                                             tile);
  return (int)cudaGetLastError();
}

// The dense map of slice blockIdx.y: map[roots[k]] = k for each root in
// [0, n), the first k of a repeated root (as a lower bound finds it in
// the sorted roots). grid (ceil(cap_n / PLANT_THREADS), B).
__global__ void __launch_bounds__(PLANT_THREADS)
plant_map_kernel(const int* __restrict__ roots, int* __restrict__ map, int n,
                 int cap_n) {
  const int k = blockIdx.x * PLANT_THREADS + threadIdx.x;
  if (k >= cap_n) return;
  const int* r = roots + (size_t)blockIdx.y * cap_n;
  const int v = r[k];
  if ((unsigned)v < (unsigned)n && (k == 0 || r[k - 1] != v))
    map[(size_t)blockIdx.y * n + v] = k;
}

// k with r[k] == l (the map's entry, held against the roots), or -1
// where l is outside [0, n) or no root
__device__ __forceinline__ int plant_find(int l, const int* m, const int* r,
                                          int n, int cap_n) {
  if ((unsigned)l >= (unsigned)n) return -1;
  const int k = __ldg(m + l);
  return (unsigned)k < (unsigned)cap_n && __ldg(r + k) == l ? k : -1;
}

// grid (ceil(n / span), B): block x paints pixels [x * span, x * span +
// span) of slice blockIdx.y, four a thread at a time where vec (n and span
// multiples of 4, L 16-byte aligned), else one.
template <int K>
__global__ void __launch_bounds__(PLANT_THREADS)
plant_kernel(const int* __restrict__ L, const int* __restrict__ roots,
             const int* __restrict__ T, const int* __restrict__ map,
             int* __restrict__ cc, int* __restrict__ painted, int n,
             int cap_n, int span, int vec) {
  const int b = blockIdx.y;
  const size_t row = (size_t)b * n;
  const int* r = roots + (size_t)b * cap_n;
  const int* m = map + row;
  const int p0 = (int)min((long long)blockIdx.x * span, (long long)n);
  const int p1 = (int)min((long long)p0 + span, (long long)n);
  auto table = [&](int ch) { return T + ((size_t)b * K + ch) * cap_n; };
  auto plane = [&](int ch) { return painted + ((size_t)b * K + ch) * n; };
  if (vec) {
    for (int p = p0 + 4 * threadIdx.x; p < p1; p += 4 * PLANT_THREADS) {
      const int4 l = __ldg(reinterpret_cast<const int4*>(L + row + p));
      const int k0 = plant_find(l.x, m, r, n, cap_n);
      const int k1 = plant_find(l.y, m, r, n, cap_n);
      const int k2 = plant_find(l.z, m, r, n, cap_n);
      const int k3 = plant_find(l.w, m, r, n, cap_n);
      *reinterpret_cast<int4*>(cc + row + p) =
          make_int4(max(k0, 0), max(k1, 0), max(k2, 0), max(k3, 0));
#pragma unroll
      for (int ch = 0; ch < K; ++ch) {
        const int* t = table(ch);
        *reinterpret_cast<int4*>(plane(ch) + p) = make_int4(
            k0 >= 0 ? __ldg(t + k0) : 0, k1 >= 0 ? __ldg(t + k1) : 0,
            k2 >= 0 ? __ldg(t + k2) : 0, k3 >= 0 ? __ldg(t + k3) : 0);
      }
    }
    return;
  }
  for (int p = p0 + threadIdx.x; p < p1; p += PLANT_THREADS) {
    const int k = plant_find(__ldg(L + row + p), m, r, n, cap_n);
    cc[row + p] = max(k, 0);
#pragma unroll
    for (int ch = 0; ch < K; ++ch)
      plane(ch)[p] = k >= 0 ? __ldg(table(ch) + k) : 0;
  }
}

}  // namespace

// L and counts ((B, n) and (B, ceil(n / tile)) ints) are scratch.
extern "C" int ccl_paint_launch(const void* vcg, const void* T, void* L,
                                void* counts, void* cc, void* N,
                                void* painted, int B, int sx, int sy, int K,
                                int cap_n, int tile, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int n = sx * sy;
  const dim3 grid((n + tile - 1) / tile, B);
  const int threads = tile_threads(tile);
  int err = converge_launch((const int*)vcg, (int*)L, (int*)counts, B, sx, n,
                            tile, s);
  if (err) return err;
  ccl_rank_kernel<false><<<grid, threads, 0, s>>>(
      (int*)L, (const int*)counts, (int*)cc, (int*)N, n, tile);
  if ((err = (int)cudaGetLastError())) return err;
  ccl_fill_kernel<<<grid, threads, (size_t)K * cap_n * sizeof(int), s>>>(
      (const int*)L, (const int*)T, (int*)cc, (int*)painted, n, K, cap_n,
      tile);
  return (int)cudaGetLastError();
}

extern "C" int ccl_min_launch(const void* vcg, void* L, void* counts,
                              void* tgt, int B, int sx, int sy, int tile,
                              void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int n = sx * sy;
  const dim3 grid((n + tile - 1) / tile, B);
  int err = converge_launch((const int*)vcg, (int*)L, (int*)counts, B, sx, n,
                            tile, s);
  if (err) return err;
  ccl_rank_kernel<true><<<grid, tile_threads(tile), 0, s>>>(
      (int*)L, (const int*)counts, (int*)tgt, nullptr, n, tile);
  return (int)cudaGetLastError();
}

// ccl_min with roots (B, cap) and N (B,) in place of tgt.
extern "C" int ccl_min_roots_launch(const void* vcg, void* L, void* counts,
                                    void* roots, void* N, int B, int sx,
                                    int sy, int cap, int tile,
                                    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int n = sx * sy;
  const dim3 grid((n + tile - 1) / tile, B);
  int err = converge_launch((const int*)vcg, (int*)L, (int*)counts, B, sx, n,
                            tile, s);
  if (err) return err;
  ccl_rank_kernel<<<grid, tile_threads(tile), 0, s>>>(
      (int*)L, (const int*)counts, (int*)roots, (int*)N, n, tile, cap);
  return (int)cudaGetLastError();
}

// map ((B, n) ints) is scratch; only its entries at the roots are written.
extern "C" int plant_launch(const void* L, const void* roots, const void* T,
                            void* map, void* cc, void* painted, int B, int n,
                            int K, int cap_n, int span, int vec,
                            void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  plant_map_kernel<<<dim3((cap_n + PLANT_THREADS - 1) / PLANT_THREADS, B),
                     PLANT_THREADS, 0, s>>>((const int*)roots, (int*)map, n,
                                            cap_n);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid((unsigned)(((long long)n + span - 1) / span), B);
  const int* l = (const int*)L;
  const int* r = (const int*)roots;
  const int* t = (const int*)T;
  const int* m = (const int*)map;
  switch (K) {
    case 0:
      plant_kernel<0><<<grid, PLANT_THREADS, 0, s>>>(
          l, r, t, m, (int*)cc, (int*)painted, n, cap_n, span, vec);
      break;
    case 1:
      plant_kernel<1><<<grid, PLANT_THREADS, 0, s>>>(
          l, r, t, m, (int*)cc, (int*)painted, n, cap_n, span, vec);
      break;
    case 2:
      plant_kernel<2><<<grid, PLANT_THREADS, 0, s>>>(
          l, r, t, m, (int*)cc, (int*)painted, n, cap_n, span, vec);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
