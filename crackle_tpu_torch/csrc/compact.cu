// The compact-cancel replay on Hopper: sorted keys -> per-close cancel
// sums -> compact close tables -> edge ids.
//
// An alternative to replay_positions (replay.cu) for the cancels, over
// the reference's sorted (depth, position) keys (replay.sorted_keys
// rebuilds them from the event words): each close gets the sum of the
// moves of its run, and the replay adds the sums at the close
// positions. Each move's next close is the close whose run holds
// it, so the edge ids equal replay_positions' element by element; that
// equality, not the TPU's means, is the contract.
//
// What bounds them on this card: cancel_sums and the replay are a
// handful of integer operations per codepoint behind a chain of
// block-wide scans per tile, like the other replay kernels, one block
// per slice with scan state riding across tiles in registers. The
// compaction is bound by bytes: the dest plane is read once (4 bytes a
// slot), a close's pos and sums once, and the tables written once. At
// one block per slice it sat on load latency (32 of 132 SMs busy at
// B = 32, one dependent 4-byte load per thread per round), so it now
// runs on a (chunks, B) grid of 16-byte loads; see kernel i.
#include "replay.cuh"

using namespace ckl;

namespace {

// Later-anchor-wins for the anchor scan: b unless b is the INT_MIN
// sentinel (cumulative sums may be negative, so LastSet's -1 will not
// do).
struct LastAnchor {
  __device__ int operator()(int a, int b) const { return b == INT_MIN ? a : b; }
};

// Kernel h. Replaces replay_big._cancel_sums_kernel. Over the sorted
// keys of a slice, forward tiled scans of the H and V cancel
// contributions (-delta: LEFT +1, RIGHT -1 in H; UP +1, DOWN -1 in V,
// in units of sx+1) give cumulative sums; an anchor marks each
// depth-segment start (the sum before it) and each close (the sum at
// it), and a close's run sum is its cumulative sum less the last
// anchor before it (0 at a segment start). The segment start reads the
// previous key itself, so a tile seam fakes none. Writes dense records
// per sorted slot: dest (close rank, -1 elsewhere), pos (the close's
// stream position, key bits & (CAP - 1) everywhere), sumH, sumV (0 off
// closes). Five carries ride in registers: both cumulative sums, both
// last anchors, the close count.
__global__ void cancel_sums_kernel(const long long* __restrict__ skeys,
                                   int* __restrict__ dest,
                                   int* __restrict__ pos,
                                   int* __restrict__ sumh,
                                   int* __restrict__ sumv, int CAP) {
  __shared__ int warp[MAX_WARPS];
  __shared__ int buf[1024];
  __shared__ int carry[5];
  const int b = blockIdx.x;
  const int T = blockDim.x;
  const long long* sk = skeys + (size_t)b * CAP;
  const size_t row = (size_t)b * CAP;
  const int logcap = 31 - __clz(CAP);

  int c_cumh = 0, c_cumv = 0, c_lah = 0, c_lav = 0, c_rank = 0;
  for (int t0 = 0; t0 < CAP; t0 += T) {
    const int j = t0 + threadIdx.x;
    int close = 0, dh = 0, dv = 0, p = 0;
    bool first = false;
    if (j < CAP) {
      const long long key = sk[j];
      const bool inf = key == LLONG_MAX;
      close = !inf && ((key >> 2) & 1);
      const long long body = key >> 3;
      p = (int)(body & (CAP - 1));
      const int cps = (int)(key & 3);
      if (!inf && !close) {
        dh = cps == 1 ? -1 : cps == 3 ? 1 : 0;
        dv = cps == 2 ? -1 : cps == 0 ? 1 : 0;
      }
      first = j == 0 || ((sk[j - 1] >> 3) >> logcap) != (body >> logcap);
    }
    int tot;
    const int cumh = block_scan(dh, 0, Add(), warp, &tot) + c_cumh;
    const int cumv = block_scan(dv, 0, Add(), warp, &tot) + c_cumv;
    int lah = block_scan(first ? cumh - dh : close ? cumh : INT_MIN, INT_MIN,
                         LastAnchor(), warp, &tot);
    int lav = block_scan(first ? cumv - dv : close ? cumv : INT_MIN, INT_MIN,
                         LastAnchor(), warp, &tot);
    if (lah == INT_MIN) lah = c_lah;
    if (lav == INT_MIN) lav = c_lav;
    const int lah_prev = shift_prev(lah, c_lah, buf);
    const int lav_prev = shift_prev(lav, c_lav, buf);
    const int rank = block_scan(close, 0, Add(), warp, &tot) + c_rank;
    if (j < CAP) {
      const bool sums = close && !first;
      dest[row + j] = close ? rank - 1 : -1;
      pos[row + j] = p;
      sumh[row + j] = sums ? cumh - lah_prev : 0;
      sumv[row + j] = sums ? cumv - lav_prev : 0;
    }
    if (threadIdx.x == T - 1) {
      carry[0] = cumh; carry[1] = cumv; carry[2] = lah; carry[3] = lav;
      carry[4] = rank;
    }
    __syncthreads();
    c_cumh = carry[0]; c_cumv = carry[1]; c_lah = carry[2]; c_lav = carry[3];
    c_rank = carry[4];
    __syncthreads();
  }
}

// Kernel i. Replaces replay_big._compact_kernel. The rank is the
// destination, so each close record is one plain store into the
// slice's (3, CCAP) tables (pos, sumH, sumV). A rank at or past CCAP
// (only a corrupt stream) is dropped, never stored out of bounds; the
// CRC gate reports the slice. The TPU's window limits and one-hot
// matmuls at HIGHEST precision are not needed.
//
// Grid (chunks, B): a block of CC_THREADS threads takes CC_SLOTS dest
// slots of one slice, CC_VEC 16-byte loads a thread issued together
// (B = 32 at CAP 32768 gives 512 blocks), and reads pos, sumH and sumV
// only at closes. Ranks are a prefix count over the slice's slots
// (cancel_sums writes them so), so entries below the slice's close
// count n are each stored by exactly one close and entries from n up
// are the empty ones (pos CAP, sums 0): the two sets are disjoint, and
// the empty fill needs no order against the stores, only n, which is
// the sum of the chunks' close counts. So each block adds its count and
// a ticket in one 64-bit atomicAdd to the slice's word of `scratch`
// ((B,) zeroed int64 from the wrapper: ticket << 32 | count); the block
// that draws the last ticket reads the whole count in the value the
// add returns and fills the tail. One launch, each table entry written
// once (a fill before a barrier wrote the table twice), no fence.
constexpr int CC_THREADS = 256;
constexpr int CC_VEC = 2;
constexpr int CC_SLOTS = 4 * CC_VEC * CC_THREADS;

__device__ __forceinline__ void fill_int(int* p, int lo, int hi, int v,
                                         bool vec) {
  if (vec) {  // p is 16-byte aligned: head to a multiple of 4, then int4
    const int a = min((lo + 3) & ~3, hi);
    for (int r = lo + threadIdx.x; r < a; r += blockDim.x) p[r] = v;
    const int4 q = make_int4(v, v, v, v);
    for (int r = a + 4 * threadIdx.x; r < hi; r += 4 * blockDim.x) {
      if (r + 4 <= hi) {
        *(int4*)(p + r) = q;
      } else {
        for (int k = r; k < hi; ++k) p[k] = v;
      }
    }
  } else {
    for (int r = lo + threadIdx.x; r < hi; r += blockDim.x) p[r] = v;
  }
}

__global__ void __launch_bounds__(CC_THREADS)
compact_closes_kernel(const int* __restrict__ dest,
                      const int* __restrict__ pos,
                      const int* __restrict__ sumh,
                      const int* __restrict__ sumv, int* __restrict__ cpos,
                      int* __restrict__ csumh, int* __restrict__ csumv,
                      unsigned long long* __restrict__ scratch, int CAP,
                      int CCAP) {
  __shared__ int warp_n[CC_THREADS / 32];
  __shared__ int tail;
  const int b = blockIdx.y;
  const size_t in = (size_t)b * CAP;
  const size_t out = (size_t)b * CCAP;
  int d[4 * CC_VEC];
#pragma unroll
  for (int i = 0; i < CC_VEC; ++i) {
    // slot runs of 4 a thread, the block's threads side by side
    const int j = blockIdx.x * CC_SLOTS + 4 * (i * CC_THREADS + threadIdx.x);
    if ((CAP & 3) == 0) {  // rows start 16-byte aligned
      int4 q = make_int4(-1, -1, -1, -1);
      if (j < CAP) q = __ldg((const int4*)(dest + in + j));
      d[4 * i] = q.x; d[4 * i + 1] = q.y; d[4 * i + 2] = q.z;
      d[4 * i + 3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        d[4 * i + k] = j + k < CAP ? __ldg(dest + in + j + k) : -1;
    }
  }
  int n = 0;  // this thread's closes
#pragma unroll
  for (int i = 0; i < 4 * CC_VEC; ++i) {
    const int j = blockIdx.x * CC_SLOTS + 4 * ((i >> 2) * CC_THREADS
                                               + threadIdx.x) + (i & 3);
    n += d[i] >= 0;
    if (d[i] >= 0 && d[i] < CCAP) {
      cpos[out + d[i]] = __ldg(pos + in + j);
      csumh[out + d[i]] = __ldg(sumh + in + j);
      csumv[out + d[i]] = __ldg(sumv + in + j);
    }
  }
  n = __reduce_add_sync(FULL_MASK, n);
  if ((threadIdx.x & 31) == 0) warp_n[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < CC_THREADS / 32; ++w) n += warp_n[w];
    const unsigned long long was =
        atomicAdd(scratch + b, (1ull << 32) | (unsigned)n);
    const bool last = (int)(was >> 32) == (int)gridDim.x - 1;
    tail = last ? (int)min((was & 0xffffffffull) + n, (unsigned long long)CCAP)
                : -1;
  }
  __syncthreads();
  if (tail >= 0) {
    const bool vec = (CCAP & 3) == 0;
    fill_int(cpos + out, tail, CCAP, CAP, vec);
    fill_int(csumh + out, tail, CCAP, 0, vec);
    fill_int(csumv + out, tail, CCAP, 0, vec);
  }
}

// Kernel j. Replaces replay_big._replay_kernel_compact. Each table
// entry stores its sums at its close position in the (2, CAP) cancel
// buffer; positions are unique within a slice, so plain stores do it
// (the reference's sort of the tables by position only windowed the
// TPU's scatter, and is dropped). After a barrier, replay_forward, as
// in replay_positions.
__global__ void replay_positions_compact_kernel(
    const int* __restrict__ cls, const int* __restrict__ cpos,
    const int* __restrict__ csumh, const int* __restrict__ csumv,
    const int* __restrict__ nodes, int* __restrict__ cancel,
    int* __restrict__ ids, int CAP, int CCAP, int CAP_CH, int sx, int sy) {
  const int b = blockIdx.x;
  const int T = blockDim.x;
  int* can = cancel + (size_t)b * 2 * CAP;
  const size_t tab = (size_t)b * CCAP;
  for (int i = threadIdx.x; i < 2 * CAP; i += T) can[i] = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < CCAP; r += T) {
    const int p = cpos[tab + r];
    if (p >= 0 && p < CAP) {
      can[p] = csumh[tab + r];
      can[CAP + p] = csumv[tab + r];
    }
  }
  __syncthreads();

  __shared__ long long warpl[MAX_WARPS];
  replay_forward(cls + (size_t)b * CAP, nodes + (size_t)b * CAP_CH, can,
                 ids + (size_t)b * CAP, CAP, CAP_CH, sx, sy, warpl);
}

}  // namespace

extern "C" {

int cancel_sums_launch(const void* skeys, void* dense, int B, int CAP,
                       int tile, void* stream) {
  int* d = (int*)dense;  // (4, B, CAP): dest, pos, sumH, sumV
  const size_t plane = (size_t)B * CAP;
  cancel_sums_kernel<<<B, tile, 0, (cudaStream_t)stream>>>(
      (const long long*)skeys, d, d + plane, d + 2 * plane, d + 3 * plane,
      CAP);
  return (int)cudaGetLastError();
}

int compact_closes_launch(const void* dense, void* tables, void* scratch,
                          int B, int CAP, int CCAP, void* stream) {
  const int* d = (const int*)dense;
  int* t = (int*)tables;  // (3, B, CCAP): pos, sumH, sumV
  const size_t plane = (size_t)B * CAP;
  const size_t tplane = (size_t)B * CCAP;
  const int chunks = (CAP + CC_SLOTS - 1) / CC_SLOTS;
  const dim3 grid(chunks > 0 ? chunks : 1, B);
  compact_closes_kernel<<<grid, CC_THREADS, 0, (cudaStream_t)stream>>>(
      d, d + plane, d + 2 * plane, d + 3 * plane, t, t + tplane, t + 2 * tplane,
      (unsigned long long*)scratch, CAP, CCAP);
  return (int)cudaGetLastError();
}

int replay_positions_compact_launch(const void* cls, const void* tables,
                                    const void* nodes, void* cancel, void* ids,
                                    int B, int CAP, int CCAP, int CAP_CH,
                                    int sx, int sy, int tile, void* stream) {
  const int* t = (const int*)tables;
  const size_t tplane = (size_t)B * CCAP;
  replay_positions_compact_kernel<<<B, tile, 0, (cudaStream_t)stream>>>(
      (const int*)cls, t, t + tplane, t + 2 * tplane, (const int*)nodes,
      (int*)cancel, (int*)ids, CAP, CCAP, CAP_CH, sx, sy);
  return (int)cudaGetLastError();
}

}  // extern "C"
