// The forward position replay that replay_positions (replay.cu) and
// replay_positions_compact (compact.cu) share.
#pragma once
#include "common.cuh"

namespace ckl {

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
  const int NV = sy * sxe;
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
      delta = mv ? (cps == 0 ? -sxe : cps == 1 ? 1 : cps == 2 ? sxe : -1) : 0;
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
        const long long pb = pos_after + base - delta;
        const long long py = floor_div(pb, sxe);
        const long long px = pb - py * sxe;
        const long long ey = cps == 0 ? py - 1 : py;
        const long long ex = cps == 3 ? px - 1 : px;
        if (cps == 1 || cps == 3) {
          if (ey >= 0 && ey <= sy && ex >= 0 && ex < sx)
            id = NV + (int)ey * sx + (int)ex;
        } else if (ey >= 0 && ey < sy && ex >= 0 && ex < sxe) {
          id = (int)ey * sxe + (int)ex;
        }
      }
      ids[i] = id;
    }
  }
}

}  // namespace ckl
