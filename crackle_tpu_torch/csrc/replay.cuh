// What the replay kernels of replay.cu and compact.cu share: the edge
// id arithmetic of replay_positions and replay_positions_compact, and
// the forward walk of replay_positions and cancel_sums.
#pragma once
#include "common.cuh"

namespace ckl {

// A move's position delta: UP -(sx+1), RIGHT +1, DOWN +(sx+1), LEFT -1.
__device__ __forceinline__ int move_delta(int cps, int sxe) {
  return cps == 0 ? -sxe : cps == 1 ? 1 : cps == 2 ? sxe : -1;
}

// The edge id of a move of direction cps from corner position pb (64
// bits: a corrupt stream's moves can sum past 2^31, CAP * (sx + 1) at
// worst, and a wrapped int32 could land on an in-range edge id where the
// plain version masks it): V plane sy x (sx+1), then H plane (sy+1) x
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

// The forward walk's depth tables. replay_positions (replay.cu) and
// cancel_sums (compact.cu) keep, per depth - drange.lo, the pending H
// and V sums of the moves since that depth's last close: each active
// move at position p and depth d takes its +-1 at the first active close
// q > p of depth d, so a close's cancel (its run sum) is its depth's
// pending sum, which then resets to 0. An entry is an int2 {2 * h +
// closed, v}: the pending sums, and whether the walk flushed that depth;
// cancel_sums' int4 adds the depth's event and close counts {.., events,
// closes}, from which a lane reads its slot and rank in the reference's
// sorted (depth, position) order.
struct WalkOut {
  int2 cancel;  // this lane's cancel (H, V), 0 off closes
  int slot;     // with an int4 table, at an active lane: the table's
  int rank;     // event and close counts, plus the group's lanes below
};

// One warp step of the walk over 32 positions, one a lane, in order:
// __match_any_sync groups the lanes by depth; a close takes the moves of
// its group since the group's previous close (popcounts of four move
// ballots over a lane mask), plus the table's pending sums if it is the
// group's first close; the group's last close (or its last lane, with no
// close) writes the table once.
template <class E>
__device__ __forceinline__ WalkOut walk_step(int e, int c, E* tab, int dlo,
                                             int R, int lane) {
  constexpr bool COUNT = sizeof(E) == sizeof(int4);
  const unsigned lt = (1u << lane) - 1;
  const int cps = c & 3;
  const int k = (e >> 2) - dlo;
  const bool act = (e & 1) && k >= 0 && k < R;
  const bool close = act && ((e >> 1) & 1);
  const bool move = act && !close;
  const unsigned g = __match_any_sync(FULL_MASK, act ? k : -1);
  const unsigned closes = __ballot_sync(FULL_MASK, close);
  const unsigned mL = __ballot_sync(FULL_MASK, move && cps == 3);
  const unsigned mR = __ballot_sync(FULL_MASK, move && cps == 1);
  const unsigned mU = __ballot_sync(FULL_MASK, move && cps == 0);
  const unsigned mD = __ballot_sync(FULL_MASK, move && cps == 2);
  auto sum_h = [&](unsigned m) { return __popc(mL & m) - __popc(mR & m); };
  auto sum_v = [&](unsigned m) { return __popc(mU & m) - __popc(mD & m); };
  const unsigned gc = closes & g;
  WalkOut out{make_int2(0, 0), 0, 0};
  E p{};
  if constexpr (COUNT) {
    if (act) {
      p = tab[k];
      out.slot = p.z + __popc(g & lt);
      out.rank = p.w + __popc(gc & lt);
    }
  }
  if (close) {
    const unsigned prior = gc & lt;
    // the group's lanes below this one, after its previous close if any
    const unsigned m = prior ? g & lt & ~((2u << (31 - __clz(prior))) - 1)
                             : g & lt;
    out.cancel = make_int2(sum_h(m), sum_v(m));
    if (!prior) {
      if constexpr (!COUNT) p = tab[k];
      out.cancel.x += p.x >> 1;
      out.cancel.y += p.y;
    }
  }
  __syncwarp();
  if (act && lane == 31 - __clz(gc ? gc : g)) {
    int x, y;
    if (gc) {  // the moves after the group's last close
      const unsigned m = g & ~((2u << lane) - 1);
      x = 2 * sum_h(m) + 1;
      y = sum_v(m);
    } else {
      if constexpr (!COUNT) p = tab[k];
      x = p.x + 2 * sum_h(g);
      y = p.y + sum_v(g);
    }
    if constexpr (COUNT) {
      tab[k] = make_int4(x, y, p.z + __popc(g), p.w + __popc(gc));
    } else {
      tab[k] = make_int2(x, y);
    }
  }
  __syncwarp();
  return out;
}

}  // namespace ckl
