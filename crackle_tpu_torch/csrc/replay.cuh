// The edge id arithmetic that replay_positions (replay.cu) and
// replay_positions_compact (compact.cu) share, and the latter's
// forward position replay.
#pragma once
#include "common.cuh"

namespace ckl {

// A move's position delta: UP -(sx+1), RIGHT +1, DOWN +(sx+1), LEFT -1.
__device__ __forceinline__ int move_delta(int cps, int sxe) {
  return cps == 0 ? -sxe : cps == 1 ? 1 : cps == 2 ? sxe : -1;
}

// The edge id of a move of direction cps from corner position pb (64
// bits: see replay_forward): V plane sy x (sx+1), then H plane (sy+1) x
// sx; -1 where out of range.
__device__ __forceinline__ int edge_id(long long pb, int cps, int sx,
                                       int sy) {
  const int sxe = sx + 1;
  long long py, px;
  if (pb >= 0 && pb <= INT_MAX) {  // every in-range edge: 32-bit division
    const unsigned q = (unsigned)pb / (unsigned)sxe;
    py = q;
    px = (unsigned)pb - q * (unsigned)sxe;
  } else {
    py = floor_div(pb, sxe);
    px = pb - py * sxe;
  }
  const long long ey = cps == 0 ? py - 1 : py;
  const long long ex = cps == 3 ? px - 1 : px;
  if (cps == 1 || cps == 3) {
    if (ey >= 0 && ey <= sy && ex >= 0 && ex < sx)
      return sy * sxe + (int)ey * sx + (int)ex;
  } else if (ey >= 0 && ey < sy && ex >= 0 && ex < sxe) {
    return (int)ey * sxe + (int)ex;
  }
  return -1;
}

// One slice, one block: a forward tiled cumsum of each codepoint's
// move delta, the H and V cancels at its position (`can`, (2, CAP),
// written before a barrier) and its chain base gives every move's
// position and its edge id: V plane sy x (sx+1), then H plane
// (sy+1) x sx; -1 where out of range (corrupt streams; the CRC gate
// reports them). Positions add up in 64 bits: a corrupt stream's moves
// can sum past 2^31 (CAP * (sx + 1) at worst), and a wrapped int32
// could land on an in-range edge id where the plain version masks it.
// `warpl` is MAX_WARPS elements of shared scratch; every thread of the
// block must call it.
__device__ __forceinline__ void replay_forward(
    const int* __restrict__ cls, const int* __restrict__ nodes,
    const int* can, int* __restrict__ ids, int CAP, int CAP_CH, int sx,
    int sy, long long* warpl) {
  const int T = blockDim.x;
  const int sxe = sx + 1;
  long long pcarry = 0;
  for (int t0 = 0; t0 < CAP; t0 += T) {
    const int i = t0 + threadIdx.x;
    long long acc = 0;
    int cps = 0, mv = 0, chain = 0, delta = 0;
    if (i < CAP) {
      const int c = cls[i];
      cps = c & 3;
      mv = (c >> 2) & 1;
      chain = c >> 3;
      delta = mv ? move_delta(cps, sxe) : 0;
      acc = delta + __ldcg(&can[i]) + (long long)sxe * __ldcg(&can[CAP + i]);
    }
    long long tot;
    const long long pos_after =
        block_scan(acc, 0LL, Add(), warpl, &tot) + pcarry;
    pcarry += tot;
    if (i < CAP) {
      int id = -1;
      if (mv) {
        const long long base =
            (chain >= 0 && chain < CAP_CH) ? nodes[chain] : 0;
        id = edge_id(pos_after + base - delta, cps, sx, sy);
      }
      ids[i] = id;
    }
  }
}

}  // namespace ckl
