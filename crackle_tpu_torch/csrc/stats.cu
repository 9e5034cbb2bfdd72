// Kernel 7: per-component slice statistics of a CCL image.
//
// Replaces stats_pallas._stats_kernel. For each slice and each
// component id k < cap_n: count, x-sum, y-sum, x-min, x-max, y-min,
// y-max (and a zero pad), as int64 in a (B, cap_n, 8) tensor. The TPU
// built a column histogram with one-hot blocks in f32, whose sums stop
// being exact past 2^24; here every channel is an exact integer. Empty
// components read count 0, sums 0, mins STATS_EMPTY_MIN (INT_MAX, above
// any coordinate) and maxes -1. Ids outside [0, cap_n) are not counted;
// any ids are taken, first-visit or not.
//
// What bounds it on this card: bytes. The ids are read once (4 bytes a
// pixel, 268 MB for a 256-slice window of 512^2) and the statistics
// written once (64 bytes a component); the arithmetic is a few integer
// operations a pixel, so the steps a warp takes per pixel and per run
// must stay few and short for the loads to keep the memory busy. The
// first design ran one 1024-thread block per slice (32 of 132 SMs busy
// at B = 32), each thread walking 32 pixels of a row in 4-byte loads (a
// warp's loads touched 32 lines at once), with 7 shared atomics per
// run, 32-pixel runs of the background included. This one:
// - runs a (bands, B) grid: a band is band_rows whole rows, at most 32
//   (the wrapper's stats.BAND_PX pixels), so B = 32 at 512^2 gives 512
//   blocks of 256 threads, about 4 a SM;
// - splits a band among its warps in contiguous ranges, and a warp
//   walks its range in spans of 128 pixels, one 16-byte load a lane
//   (the next span's already in flight), so each load instruction reads
//   512 consecutive bytes;
// - finds runs in registers: a pixel starts a run where its id differs
//   from its left neighbour's (within the lane, across lanes by one
//   __shfl_up_sync) or it opens a row (at most one of a lane's 4 pixels
//   does, as rows are at least 4 wide). A ballot of the lanes holding a
//   start and one shuffle from the nearest such lane below give each
//   lane the start of the run open at its first pixel (a max-scan over
//   the warp took five dependent shuffles). The run still open at a
//   span's end rides into the next span, so a run costs one flush
//   however long: the background costs one flush a row per warp range,
//   not one per 32 pixels;
// - flushes in rounds of one run end a lane, so that the warp issues a
//   flush's atomics about once a span and not once for each of the 4
//   pixel positions where some lane holds an end;
// - flushes a run into block-local accumulators in shared memory with
//   six 32-bit atomics: count, x-sum and y-sum (a band's sums fit 32
//   bits: the wrapper checks; y is relative to the band), x-min, x-max,
//   and an OR of the run's row into a 32-bit row mask, whose lowest and
//   highest bits give the y-extent. 24 bytes a component: 24 KB at
//   cap_n 1024;
// - merges into the output only the components the band touched, with
//   64-bit global atomics (adds, and atomicMin / atomicMax on long
//   long), after a first kernel has set the output to its empty values.
#include "common.cuh"

using namespace ckl;

namespace {

constexpr int STATS_THREADS = 256;
constexpr int STATS_WARPS = STATS_THREADS / 32;
constexpr int PX = 4;  // consecutive pixels of a lane per step
constexpr int SPAN = 32 * PX;  // pixels a warp takes per step
constexpr int N_CH = 8;
constexpr int EMPTY_MIN = INT_MAX;

// Block-local accumulators of a band; y is relative to its first row.
struct Acc {
  int* cnt;
  int* xs;
  int* ys;
  int* xmin;
  int* xmax;
  unsigned* rows;  // bit y: a pixel on the band's row y
};

// The run of a counted id on band row y from x0 to x1.
__device__ __forceinline__ void flush(const Acc& a, int id, int y, int x0,
                                      int x1) {
  const int c = x1 - x0 + 1;
  atomicAdd(&a.cnt[id], c);
  atomicAdd(&a.xs[id], (int)((x0 + (long long)x1) * c / 2));
  atomicAdd(&a.ys[id], y * c);
  atomicMin(&a.xmin[id], x0);
  atomicMax(&a.xmax[id], x1);
  atomicOr(&a.rows[id], 1u << y);
}

// The ids of pixels l .. l+3 of a slice, -1 (never counted) outside
// [lo, hi). l + base is a multiple of 4, so a load wholly inside the
// range is one aligned 16-byte load.
__device__ __forceinline__ int4 load4(const int* __restrict__ img, int l,
                                      int lo, int hi) {
  if (l >= lo && l + 4 <= hi) return __ldg((const int4*)(img + l));
  int v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = (l + k >= lo && l + k < hi) ? __ldg(img + l + k) : -1;
  return make_int4(v[0], v[1], v[2], v[3]);
}

// Output rows set empty: count and sums 0, mins EMPTY_MIN, maxes -1.
// One 16-byte store a thread, over the output as (rows * 4) pairs.
__global__ void stats_init_kernel(long long* __restrict__ out,
                                  long long pairs) {
  longlong2* o = (longlong2*)out;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < pairs; i += (long long)gridDim.x * blockDim.x) {
    const int q = (int)(i & 3);
    o[i] = q == 0 ? make_longlong2(0, 0)
         : q == 1 ? make_longlong2(0, EMPTY_MIN)
         : q == 2 ? make_longlong2(-1, EMPTY_MIN)
                  : make_longlong2(-1, 0);
  }
}

// grid (bands, B); dynamic shared 24 * cap_n bytes; sx >= PX and
// band_rows <= 32; a band's sums below 2^31
__global__ void __launch_bounds__(STATS_THREADS)
slice_stats_kernel(const int* __restrict__ cc, long long* __restrict__ out,
                   int sx, int sy, int cap_n, int band_rows) {
  extern __shared__ int smem[];
  Acc a;
  a.cnt = smem;
  a.xs = a.cnt + cap_n;
  a.ys = a.xs + cap_n;
  a.xmin = a.ys + cap_n;
  a.xmax = a.xmin + cap_n;
  a.rows = (unsigned*)(a.xmax + cap_n);
  for (int k = threadIdx.x; k < cap_n; k += blockDim.x) {
    a.cnt[k] = 0;
    a.xs[k] = 0;
    a.ys[k] = 0;
    a.xmin[k] = EMPTY_MIN;
    a.xmax[k] = -1;
    a.rows[k] = 0;
  }
  __syncthreads();

  const int b = blockIdx.y;
  const int y0 = blockIdx.x * band_rows;
  const size_t base = (size_t)b * sx * sy;
  const int* img = cc + base;
  const int lo = y0 * sx;
  const int hi = min(y0 + band_rows, sy) * sx;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const int per = ((hi - lo + STATS_WARPS - 1) / STATS_WARPS + 3) & ~3;
  const int wlo = lo + (threadIdx.x >> 5) * per;
  const int whi = min(hi, wlo + per);
  if (wlo < whi) {
    // the warp's first span starts at the 16-byte boundary at or below
    // wlo: up to 3 pixels before the slice (masked, never loaded)
    const int a0 = wlo - (int)((base + wlo) & 3);
    int l = a0 + PX * lane;  // the lane's first pixel in this span
    int y = (int)floor_div(l, sx);
    int x = l - y * sx;
    const int dq = SPAN / sx;
    const int dr = SPAN - dq * sx;
    // the run open at the previous span's end (which is pixel l - 1 of
    // lane 0): its id and first pixel
    int cid = -1, cstart = a0 - 1;
    int4 nxt = load4(img, l, wlo, whi);
    for (int s = a0; s < whi; s += SPAN, l += SPAN) {
      const int4 q = nxt;
      if (s + SPAN < whi) nxt = load4(img, l + SPAN, wlo, whi);
      const int v[PX] = {q.x, q.y, q.z, q.w};
      // the lane's pixel that opens a row, PX or more for none
      const int krow = x == 0 ? 0 : sx - x;
      auto px_x = [&](int k) { return k >= krow ? k - krow : x + k; };
      auto px_y = [&](int k) { return k >= krow && krow > 0 ? y + 1 : y; };
      int prev = __shfl_up_sync(FULL_MASK, v[PX - 1], 1);
      if (lane == 0) prev = cid;
      bool st[PX];
      st[0] = krow == 0 || v[0] != prev;
      if (lane == 0 && st[0] && (unsigned)cid < (unsigned)cap_n) {
        // the run carried in ends at the pixel before this span's
        const int xe = krow == 0 ? sx - 1 : x - 1;
        flush(a, cid, (krow == 0 ? y - 1 : y) - y0, xe - (l - 1 - cstart),
              xe);
      }
      int last = -1;  // the lane's latest run start, -1 for none
#pragma unroll
      for (int k = 1; k < PX; ++k) st[k] = k == krow || v[k] != v[k - 1];
#pragma unroll
      for (int k = 0; k < PX; ++k)
        if (st[k]) last = l + k;
      // the run open at the lane's first pixel started at the latest
      // start of the nearest lane below that has one, or was carried in
      const unsigned has = __ballot_sync(FULL_MASK, last >= 0);
      const unsigned first = __ballot_sync(FULL_MASK, st[0]);
      const int src = 31 - __clz(has & below);
      int run = __shfl_sync(FULL_MASK, last, src < 0 ? 0 : src);
      if (src < 0) run = cstart;
      // pixel k ends its run where pixel k + 1 starts one (the last
      // pixel: where the next lane's first does); the run holding the
      // span's last pixel rides into the next span
      int rs[PX];
      unsigned ends = 0;
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        if (st[k]) run = l + k;
        rs[k] = run;
        const bool end = k < PX - 1 ? st[k + 1 < PX ? k + 1 : 0]
                                    : lane < 31 && (first >> (lane + 1)) & 1;
        if (end && (unsigned)v[k] < (unsigned)cap_n) ends |= 1u << k;
      }
      // one end a lane per round, so that the warp issues a flush's
      // atomics once per round (most spans take one) and not once for
      // each pixel position that holds an end in some lane
      while (__any_sync(FULL_MASK, ends)) {
        if (ends) {
          const int k = __ffs(ends) - 1;
          ends &= ends - 1;
          int id = v[0], r = rs[0];
#pragma unroll
          for (int j = 1; j < PX; ++j) {
            if (k == j) {
              id = v[j];
              r = rs[j];
            }
          }
          const int xe = px_x(k);
          flush(a, id, px_y(k) - y0, xe - (l + k - r), xe);
        }
      }
      cid = __shfl_sync(FULL_MASK, v[PX - 1], 31);
      cstart = __shfl_sync(FULL_MASK, run, 31);
      x += dr;
      y += dq;
      if (x >= sx) {
        x -= sx;
        ++y;
      }
    }
    if (lane == 0 && (unsigned)cid < (unsigned)cap_n) {
      // the run open at the warp range's end, which is pixel l - 1
      const int xe = x == 0 ? sx - 1 : x - 1;
      flush(a, cid, (x == 0 ? y - 1 : y) - y0, xe - (l - 1 - cstart), xe);
    }
  }
  __syncthreads();

  long long* o = out + (size_t)b * cap_n * N_CH;
  for (int k = threadIdx.x; k < cap_n; k += blockDim.x) {
    const unsigned rows = a.rows[k];
    if (!rows) continue;
    const long long c = a.cnt[k];
    unsigned long long* r = (unsigned long long*)(o + (size_t)k * N_CH);
    // two's complement: the unsigned add of a non-negative sum is exact
    atomicAdd(&r[0], (unsigned long long)c);
    atomicAdd(&r[1], (unsigned long long)a.xs[k]);
    atomicAdd(&r[2], (unsigned long long)(a.ys[k] + y0 * c));
    long long* m = (long long*)r;
    atomicMin(&m[3], (long long)a.xmin[k]);
    atomicMax(&m[4], (long long)a.xmax[k]);
    atomicMin(&m[5], (long long)(y0 + __ffs(rows) - 1));
    atomicMax(&m[6], (long long)(y0 + 31 - __clz(rows)));
  }
}

}  // namespace

extern "C" int slice_stats_launch(const void* cc, void* out, int B, int sx,
                                  int sy, int cap_n, int band_rows,
                                  void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long pairs = (long long)B * cap_n * N_CH / 2;
  const long long blocks = (pairs + 255) / 256;
  stats_init_kernel<<<(int)(blocks < 2048 ? blocks : 2048), 256, 0, s>>>(
      (long long*)out, pairs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || (long long)sx * sy == 0) return (int)err;
  const size_t smem = (size_t)cap_n * 6 * sizeof(int);
  if (smem > 48 * 1024) {  // above the default limit only by opt-in
    err = cudaFuncSetAttribute(slice_stats_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((sy + band_rows - 1) / band_rows, B);
  slice_stats_kernel<<<grid, STATS_THREADS, smem, s>>>(
      (const int*)cc, (long long*)out, sx, sy, cap_n, band_rows);
  return (int)cudaGetLastError();
}
