// The compact-cancel replay on Hopper: sorted keys -> per-close cancel
// sums -> compact close tables -> edge ids.
//
// An alternative to replay_positions (replay.cu) for the cancels: in
// place of one atomic +-1 per move at its scope close, each close gets
// the sum of the moves of its run, and the replay adds the sums at the
// close positions. Each move's next close is the close whose run holds
// it, so the edge ids equal replay_positions' element by element; that
// equality, not the TPU's means, is the contract.
//
// What bounds them on this card: cancel_sums and the replay are a
// handful of integer operations per codepoint behind a chain of
// block-wide scans per tile, like the other replay kernels; the
// compaction is one store per close and is bound by bytes. One block
// per slice; scan state rides across tiles in registers.
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
// slice's (3, CCAP) tables (pos, sumH, sumV) after the block has set
// them empty (pos CAP, sums 0). A rank at or past CCAP (only a corrupt
// stream) is dropped, never stored out of bounds; the CRC gate reports
// the slice. The TPU's window limits and one-hot matmuls at HIGHEST
// precision are not needed.
__global__ void compact_closes_kernel(const int* __restrict__ dest,
                                      const int* __restrict__ pos,
                                      const int* __restrict__ sumh,
                                      const int* __restrict__ sumv,
                                      int* __restrict__ cpos,
                                      int* __restrict__ csumh,
                                      int* __restrict__ csumv, int CAP,
                                      int CCAP) {
  const int b = blockIdx.x;
  const size_t in = (size_t)b * CAP;
  const size_t out = (size_t)b * CCAP;
  for (int r = threadIdx.x; r < CCAP; r += blockDim.x) {
    cpos[out + r] = CAP;
    csumh[out + r] = 0;
    csumv[out + r] = 0;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < CAP; j += blockDim.x) {
    const int d = dest[in + j];
    if (d >= 0 && d < CCAP) {
      cpos[out + d] = pos[in + j];
      csumh[out + d] = sumh[in + j];
      csumv[out + d] = sumv[in + j];
    }
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

int compact_closes_launch(const void* dense, void* tables, int B, int CAP,
                          int CCAP, void* stream) {
  const int* d = (const int*)dense;
  int* t = (int*)tables;  // (3, B, CCAP): pos, sumH, sumV
  const size_t plane = (size_t)B * CAP;
  const size_t tplane = (size_t)B * CCAP;
  compact_closes_kernel<<<B, 1024, 0, (cudaStream_t)stream>>>(
      d, d + plane, d + 2 * plane, d + 3 * plane, t, t + tplane, t + 2 * tplane,
      CAP, CCAP);
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
