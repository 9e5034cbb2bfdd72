// Kernel 7: per-component slice statistics of a first-visit CCL image.
//
// Replaces stats_pallas._stats_kernel. For each slice and each
// component id k < cap_n: count, x-sum, y-sum, x-min, x-max, y-min,
// y-max (and a zero pad), as int64 in a (B, cap_n, 8) tensor. The TPU
// built a column histogram with one-hot blocks in f32, whose sums stop
// being exact past 2^24; here counts and extents are int32 and sums
// int64, so every channel is exact. Empty components read count 0,
// sums 0, mins STATS_EMPTY_MIN (INT_MAX, above any coordinate) and
// maxes -1. Ids outside [0, cap_n) are not counted.
//
// What bounds it on this card: one block per slice reads the slice's
// ids once (1 MB at 512^2) and updates per-component accumulators in
// shared memory (36 bytes a component: 36 KB at cap_n 1024, 144 KB at
// the eligible maximum of 4096, above the default 48 KB, so the launch
// raises the block's dynamic shared-memory limit). A shared atomic per
// pixel would serialise on the background component, which covers most
// of a slice. So each thread walks a run of SEG pixels of one row and
// merges runs of equal id in registers: a run's count, x-sum and x
// extent follow from its ends, and it costs one set of shared atomics.
// First-visit ids come in long runs, so the atomics scale with the
// boundary length of the components, not with the voxels.
#include "common.cuh"

using namespace ckl;

namespace {

constexpr int STATS_THREADS = 1024;
constexpr int SEG = 32;  // pixels of one row a thread walks in order
constexpr int N_CH = 8;
constexpr int EMPTY_MIN = INT_MAX;

struct Acc {
  unsigned long long* xs;
  unsigned long long* ys;
  int* cnt;
  int* xmin;
  int* xmax;
  int* ymin;
  int* ymax;
};

__device__ __forceinline__ void flush(const Acc& a, int id, int y, int x0,
                                      int x1, int cap_n) {
  if (id < 0 || id >= cap_n) return;
  const long long c = x1 - x0 + 1;
  atomicAdd(&a.cnt[id], (int)c);
  // two's complement: the unsigned add of a non-negative sum is exact
  atomicAdd(&a.xs[id], (unsigned long long)((x0 + (long long)x1) * c / 2));
  atomicAdd(&a.ys[id], (unsigned long long)(y * c));
  atomicMin(&a.xmin[id], x0);
  atomicMax(&a.xmax[id], x1);
  atomicMin(&a.ymin[id], y);
  atomicMax(&a.ymax[id], y);
}

// grid B blocks; dynamic shared 36 * cap_n bytes
__global__ void slice_stats_kernel(const int* __restrict__ cc,
                                   long long* __restrict__ out, int sx,
                                   int sy, int cap_n) {
  extern __shared__ unsigned long long smem[];
  Acc a;
  a.xs = smem;
  a.ys = smem + cap_n;
  a.cnt = (int*)(smem + 2 * cap_n);
  a.xmin = a.cnt + cap_n;
  a.xmax = a.xmin + cap_n;
  a.ymin = a.xmax + cap_n;
  a.ymax = a.ymin + cap_n;
  for (int k = threadIdx.x; k < cap_n; k += blockDim.x) {
    a.xs[k] = 0;
    a.ys[k] = 0;
    a.cnt[k] = 0;
    a.xmin[k] = EMPTY_MIN;
    a.xmax[k] = -1;
    a.ymin[k] = EMPTY_MIN;
    a.ymax[k] = -1;
  }
  __syncthreads();

  const int b = blockIdx.x;
  const int* img = cc + (size_t)b * sx * sy;
  const int segs_per_row = (sx + SEG - 1) / SEG;
  const int n_segs = segs_per_row * sy;
  for (int s = threadIdx.x; s < n_segs; s += blockDim.x) {
    const int y = s / segs_per_row;
    const int xa = (s - y * segs_per_row) * SEG;
    const int xb = min(xa + SEG, sx);
    const int* row = img + (size_t)y * sx;
    int id = __ldg(&row[xa]);
    int x0 = xa;
    for (int x = xa + 1; x < xb; ++x) {
      const int v = __ldg(&row[x]);
      if (v != id) {
        flush(a, id, y, x0, x - 1, cap_n);
        id = v;
        x0 = x;
      }
    }
    flush(a, id, y, x0, xb - 1, cap_n);
  }
  __syncthreads();

  long long* o = out + (size_t)b * cap_n * N_CH;
  for (int k = threadIdx.x; k < cap_n; k += blockDim.x) {
    long long* r = o + (size_t)k * N_CH;
    r[0] = a.cnt[k];
    r[1] = (long long)a.xs[k];
    r[2] = (long long)a.ys[k];
    r[3] = a.xmin[k];
    r[4] = a.xmax[k];
    r[5] = a.ymin[k];
    r[6] = a.ymax[k];
    r[7] = 0;
  }
}

}  // namespace

extern "C" int slice_stats_launch(const void* cc, void* out, int B, int sx,
                                  int sy, int cap_n, void* stream) {
  const size_t smem = (size_t)cap_n * (2 * sizeof(long long) + 5 * sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      slice_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  slice_stats_kernel<<<B, STATS_THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)cc, (long long*)out, sx, sy, cap_n);
  return (int)cudaGetLastError();
}
