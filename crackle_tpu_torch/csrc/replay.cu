// Crack-code replay on Hopper: packed 2-bit moves -> 4-bit VCG.
//
// Three kernels. Semantics are those of
// crackle_tpu/kernels/decode.py:_decode_vcg_batch; the stage outputs
// (event words, cls, edge ids, VCG) are the contract, not the TPU's
// means. The reference groups a slice's events by depth with a global
// sort of (depth, position) keys, because on the TPU sorts and scans
// are cheap and scalar gathers and scatters are not. On this card a
// table lookup in shared memory is one load, and the sort cost four
// times the two replay kernels together, so replay_positions walks the
// events forward with a per-depth table instead and no sort runs.
//
// What bounds them on this card: a handful of integer operations per
// codepoint over (B, CAP) arrays (CAP = 32768 for a 512^2 slice). Bytes
// would allow some 40-70 us at B = 512; the kernels are held back by
// serial dependences (the block scans of replay_keys, the walk of
// replay_positions), which the designs below keep short.
#include "replay.cuh"

using namespace ckl;

namespace {

__device__ __forceinline__ int diff_at(const uint8_t* pk, int i) {
  return (pk[i >> 2] >> (2 * (i & 3))) & 3;
}

// ---------------------------------------------------------------------------
// Kernel 1: replay_keys
// ---------------------------------------------------------------------------

constexpr int KEYS_PER = 32;  // codepoints a thread takes: 8 bytes, one load

// The classification of one codepoint from its diff d and the next
// codepoint's dn (both 0 past the stream's end), carrying the mod-4
// codepoint, the previous reversal flag and the reversal run's start.
// r(i) = (cps(i) ^ cps(i-1)) == 2 is d(i) == 2 for i >= 1, so it needs
// no carry; the pair-second parity needs the run start, a max.
struct Classify {
  int cps, rp, run_start;
  int second, is_term, is_branch, is_move;
  __device__ __forceinline__ void step(int i, int d, int dn, bool inr) {
    cps = (cps + d) & 3;
    const int r = i >= 1 && d == 2;
    if (r && !rp) run_start = i;
    rp = r;
    second = r && (((i - run_start) & 1) == 0);
    const int cps1 = (cps + dn) & 3;
    const int pair_first = dn == 2 && !second;
    const int term_pair = cps1 == 0 || cps1 == 3;
    is_term = pair_first && term_pair;
    is_branch = pair_first && !term_pair;
    is_move = !pair_first && !second && inr;
  }
};

// Replaces replay_pallas._keys_kernel and replay_big._keys_kernel_big:
// 2-bit diffs -> mod-4 cumsum codepoints -> move/branch/terminate
// classes, chain ids and scope depth -> one int32 event word per
// codepoint, depth << 2 | close << 1 | 1 where active (0 elsewhere), a
// cls word cps | move << 2 | chain << 3, and the slice's least and
// largest active depth (drange, (0, -1) without events).
//
// One block a slice; each thread owns KEYS_PER consecutive codepoints
// of a block step (blockDim * KEYS_PER codepoints; one step at CAP
// 32768 and 1024 threads). The carries are associative once taken in
// order, so each is one block scan of per-thread values: the codepoint
// (a sum mod 4) and the run start (a max), read off the thread's 8
// bytes with bit operations; c (a sum) and its prefix minimum (a min of
// each thread's c_in + local minimum), from a serial pass over the
// thread's run; the end count (a sum) and the previous codepoint's
// is_end (the last set value), from that pass's minima in closed form.
// Six block scans a step, where one codepoint a thread took five scans
// and four shifts a 1024-codepoint tile (about 800 barriers a slice);
// a second serial pass writes the outputs. The outputs go out
// through shared memory, eight values a thread per round, so that each
// warp store writes whole 32-byte sectors.
__global__ void __launch_bounds__(1024)
replay_keys_kernel(const uint8_t* __restrict__ packed,
                   const int* __restrict__ nbytes,
                   const int* __restrict__ n_chains, int* __restrict__ ev,
                   int* __restrict__ cls, int* __restrict__ drange, int CAP_B,
                   int vec) {
  __shared__ int warp[MAX_WARPS];
  __shared__ int xbuf[MAX_WARPS][32 * 9];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int CAP = CAP_B * 4;
  const uint8_t* pk = packed + (size_t)b * CAP_B;
  int* eout = ev + (size_t)b * CAP;
  int* cout = cls + (size_t)b * CAP;
  const int n_cps = nbytes[b] * 4;
  const int n_eff = min(n_cps, CAP);
  const int nch = n_chains[b];
  const int chmax = max(nch - 1, 0);
  const int step = blockDim.x * KEYS_PER;

  int cps_c = 0, rs_c = -1, c_c = 0, cm_c = INT_MAX, ec_c = 0, ie_c = 0;
  int lo = INT_MAX, hi = INT_MIN;
  for (int t0 = 0; t0 < CAP; t0 += step) {
    const int i0 = t0 + threadIdx.x * KEYS_PER;
    // this thread's diffs, 0 past the stream's end
    unsigned long long w = 0;
    const int byte0 = i0 >> 2;
    if (vec && byte0 + 8 <= CAP_B) {
      w = *(const unsigned long long*)(pk + byte0);
    } else {
      for (int k = 0; k < 8; ++k)
        if (byte0 + k < CAP_B) w |= (unsigned long long)pk[byte0 + k] << (8 * k);
    }
    const int keep = min(max(n_eff - i0, 0), KEYS_PER);
    if (keep < KEYS_PER) w &= (1ull << (2 * keep)) - 1;
    const int d_next = i0 + KEYS_PER < n_eff ? diff_at(pk, i0 + KEYS_PER) : 0;
    const int rp0 = i0 - 1 >= 1 && i0 - 1 < n_eff && diff_at(pk, i0 - 1) == 2;
    auto d_at = [&](int j) {
      return j < KEYS_PER ? (int)((w >> (2 * j)) & 3) : d_next;
    };

    // the codepoint sum and the last reversal-run start, bitwise: bit
    // 2j of t is r(i0 + j), d == 2
    const unsigned long long E = 0x5555555555555555ull;
    const int dsum = __popcll(w & E) + 2 * __popcll(w & (E << 1));
    unsigned long long t = (w >> 1) & ~w & E;
    if (i0 == 0) t &= ~1ull;  // r(0) = 0
    const unsigned long long starts = t & ~((t << 2) | (unsigned long long)rp0);
    const int rs_loc = starts ? i0 + (63 - __clzll(starts)) / 2 : -1;
    int tot_d, tot_rs;
    const int cps_in = (cps_c + block_scan_excl(dsum, 0, Add(), warp, &tot_d)) & 3;
    const int rs_in = max(rs_c, block_scan_excl(rs_loc, -1, Max(), warp, &tot_rs));

    // pass 1: c, relative to the thread's start: its minimum, its first
    // value c0, the minimum after it, its last value and the minimum
    // before that
    int c_rel = 0, min_rel = INT_MAX, c0 = 0, min_rest = INT_MAX;
    int min_pre_last = INT_MAX;
    {
      Classify k{cps_in, rp0, rs_in};
      for (int j = 0; j < KEYS_PER; ++j) {
        k.step(i0 + j, d_at(j), d_at(j + 1), i0 + j < n_eff);
        c_rel += k.is_branch - k.is_term;
        if (j == 0) c0 = c_rel;
        else min_rest = min(min_rest, c_rel);
        if (j == KEYS_PER - 1) min_pre_last = min_rel;
        min_rel = min(min_rel, c_rel);
      }
    }
    int tot_c, tot_m;
    const int c_in = c_c + block_scan_excl(c_rel, 0, Add(), warp, &tot_c);
    const int cm_in = min(cm_c, block_scan_excl(c_in + min_rel, INT_MAX, Min(),
                                                warp, &tot_m));

    // chain ends, without a pass: is_end(i) is c(i) < min(cm(i-1), 0),
    // that is c_rel(i) < min(X, the minimum of c_rel before i) with X =
    // min(cm_in, 0) - c_in. c_rel moves in steps of at most 1, so after
    // the first codepoint each new low below min(X, c0) is one end, and
    // a codepoint past the stream's end (c_rel unchanged) is none.
    const int X = min(cm_in, 0) - c_in;
    const int e0 = i0 < n_eff && c0 < X;
    const int ecnt = e0 + max(0, min(X, c0) - min_rest);
    const int last_end = c_rel < min(X, min_pre_last);
    int tot_e, tot_le;
    const int ec_in = ec_c + block_scan_excl(ecnt, 0, Add(), warp, &tot_e);
    const int le = block_scan_excl(last_end, -1, LastSet(), warp, &tot_le);

    // pass 2: the outputs, eight codepoints a round
    {
      Classify k{cps_in, rp0, rs_in};
      int c = c_in, cm = cm_in, end_cum = ec_in;
      int prev_end = le >= 0 ? le : ie_c;
      int* xb = xbuf[wid];
      for (int r = 0; r < KEYS_PER / 8; ++r) {
        int evr[8], clr[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int i = i0 + 8 * r + jj;
          const bool inr = i < n_eff;
          k.step(i, d_at(8 * r + jj), d_at(8 * r + jj + 1), inr);
          c += k.is_branch - k.is_term;
          const int is_end = inr && c < min(cm, 0);
          cm = min(cm, c);
          end_cum += is_end;
          const int cnt_before = end_cum - is_end;
          const int chain_of = min(max(cnt_before, 0), chmax);
          const int valid = cnt_before < nch || prev_end;
          prev_end = is_end;
          const int depth = c + chain_of + 1 + k.is_term;
          const int close = k.is_term && valid;
          const int active = valid && (k.is_move || k.is_term);
          if (active) {
            lo = min(lo, depth);
            hi = max(hi, depth);
          }
          evr[jj] = active ? (int)(((unsigned)depth << 2) | (close << 1) | 1) : 0;
          clr[jj] = k.cps | ((k.is_move && valid) << 2) | (chain_of << 3);
        }
        // blocked to striped: lane l's values [8r, 8r + 8) -> 8 stores,
        // each 4 runs of 8 consecutive ints across the warp
        for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) xb[lane * 9 + jj] = pass ? clr[jj] : evr[jj];
          __syncwarp();
          int* out = pass ? cout : eout;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int e = 32 * q + lane;
            const int owner = e >> 3, o = e & 7;
            const int i = t0 + (wid * 32 + owner) * KEYS_PER + 8 * r + o;
            if (i < CAP) out[i] = xb[owner * 9 + o];
          }
          __syncwarp();
        }
      }
    }
    cps_c = (cps_c + tot_d) & 3;
    rs_c = max(rs_c, tot_rs);
    c_c += tot_c;
    cm_c = min(cm_c, tot_m);
    ec_c += tot_e;
    ie_c = tot_le >= 0 ? tot_le : ie_c;
  }
  int glo, ghi;
  block_scan(lo, INT_MAX, Min(), warp, &glo);
  block_scan(hi, INT_MIN, Max(), warp, &ghi);
  if (threadIdx.x == 0) {
    drange[2 * b] = glo <= ghi ? glo : 0;
    drange[2 * b + 1] = glo <= ghi ? ghi : -1;
  }
}

// ---------------------------------------------------------------------------
// Kernel 2: replay_positions
// ---------------------------------------------------------------------------

// Replaces replay_pallas._replay_kernel and replay_big's _scope_kernel
// and _replay_kernel_big. The reference's sorted definition reduces to:
// each active move at position p and depth d takes its +-1 (H or V) at
// the first active close q > p of depth d, and nothing if there is none.
// So a forward walk over the positions keeps, per depth, the pending H
// and V sums of the moves since that depth's last close: a close's
// cancel is its depth's pending sum, which then resets to 0. Each
// close's cancel is known when the walk reaches it, so the same walk
// runs the 64-bit position scan and writes the edge ids: no sort, no
// cancel buffer in device memory, no atomics on it. The walk's step and
// its tables are in replay.cuh.

// The walk over positions [s0, s1) of a slice by one warp, from the
// pending sums in `tab` and the position `pcarry` before s0: the
// 64-bit position scan and the edge ids (the next step's words loaded
// ahead).
__device__ __forceinline__ void walk_ids(
    const int* __restrict__ e_row, const int* __restrict__ c_row,
    const int* __restrict__ nd, int* __restrict__ out, int2* tab, int dlo,
    int R, int s0, int s1, long long pcarry, int CAP_CH, int sx, int sy,
    int lane) {
  const int sxe = sx + 1;
  int e_nx = s0 + lane < s1 ? e_row[s0 + lane] : 0;
  int c_nx = s0 + lane < s1 ? c_row[s0 + lane] : 0;
  for (int t0 = s0; t0 < s1; t0 += 32) {
    const int i = t0 + lane;
    const int e = e_nx, c = c_nx;
    if (i + 32 < s1) {
      e_nx = e_row[i + 32];
      c_nx = c_row[i + 32];
    }
    const int2 cn = walk_step(e, c, tab, dlo, R, lane).cancel;
    const int cps = c & 3;
    const int mv = (c >> 2) & 1;
    const int delta = mv ? move_delta(cps, sxe) : 0;
    long long acc = delta + cn.x + (long long)sxe * cn.y;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long n = __shfl_up_sync(FULL_MASK, acc, o);
      if (lane >= o) acc += n;
    }
    const long long pos_after = pcarry + acc;
    pcarry += __shfl_sync(FULL_MASK, acc, 31);
    if (i < s1) {
      int id = -1;
      if (mv) {
        const int chain = c >> 3;
        const long long base = chain < CAP_CH ? nd[chain] : 0;
        id = edge_id(pos_after + base - delta, cps, sx, sy);
      }
      out[i] = id;
    }
  }
}

// One block a slice. Where the slice's depth range fits `budget`
// entries, its warps split it into blockDim / 32 segments, one each, and
// the tables live in shared memory (`budget` entries a warp):
//   1. each warp walks its segment from empty tables: per depth, the
//      moves after the segment's last close (closed) or all of them, and
//      the segment's local sum of position steps;
//   2. per depth, one thread carries the pending sums over the segments
//      in order, so each segment's table receives the sums pending at
//      its start; each depth that a segment closes adds them to that
//      segment's position steps (its first close of the depth takes
//      them);
//   3. each warp walks its segment again from those sums and its
//      position carry (the steps of the segments before it), writing
//      the ids.
// Otherwise (a corrupt stream's range; the budget's shrunk in tests)
// warp 0 walks the whole slice with the table in the slice's row of
// `scratch` (stride entries).
__global__ void __launch_bounds__(1024)
replay_positions_kernel(const int* __restrict__ ev, const int* __restrict__ cls,
                        const int* __restrict__ drange,
                        const int* __restrict__ nodes, int2* __restrict__ scratch,
                        int* __restrict__ ids, int CAP, int CAP_CH, int sx,
                        int sy, int budget, int stride) {
  extern __shared__ int2 tabs[];
  __shared__ long long steps[MAX_WARPS], extra[MAX_WARPS];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int sxe = sx + 1;
  const int* e_row = ev + (size_t)b * CAP;
  const int* c_row = cls + (size_t)b * CAP;
  const int* nd = nodes + (size_t)b * CAP_CH;
  int* out = ids + (size_t)b * CAP;
  const int dlo = drange[2 * b];
  const int R = min(max(drange[2 * b + 1] - dlo + 1, 0), stride);

  if (R > budget) {
    if (wid == 0) {
      int2* tab = scratch + (size_t)b * stride;
      for (int k = lane; k < R; k += 32) tab[k] = make_int2(0, 0);
      __syncwarp();
      walk_ids(e_row, c_row, nd, out, tab, dlo, R, 0, CAP, 0, CAP_CH, sx, sy,
               lane);
    }
    return;  // uniform over the block: no barrier follows
  }

  const int L = (CAP + W - 1) / W;
  const int s0 = min(wid * L, CAP), s1 = min(s0 + L, CAP);
  int2* tab = tabs + (size_t)wid * budget;
  for (int k = lane; k < R; k += 32) tab[k] = make_int2(0, 0);
  if (threadIdx.x < MAX_WARPS) extra[threadIdx.x] = 0;
  __syncwarp();

  // 1: the local walk
  long long local = 0;
  for (int t0 = s0; t0 < s1; t0 += 32) {
    const int i = t0 + lane;
    const int e = i < s1 ? e_row[i] : 0;
    const int c = i < s1 ? c_row[i] : 0;
    const int2 cn = walk_step(e, c, tab, dlo, R, lane).cancel;
    const int delta = (c >> 2) & 1 ? move_delta(c & 3, sxe) : 0;
    local += delta + cn.x + (long long)sxe * cn.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) local += __shfl_xor_sync(FULL_MASK, local, o);
  if (lane == 0) steps[wid] = local;
  __syncthreads();

  // 2: the pending sums at each segment's start
  for (int k = threadIdx.x; k < R; k += blockDim.x) {
    int h = 0, v = 0;
    for (int s = 0; s < W; ++s) {
      const int2 o = tabs[(size_t)s * budget + k];
      tabs[(size_t)s * budget + k] = make_int2(2 * h, v);
      if (o.x & 1) {
        if (h || v)
          atomicAdd((unsigned long long*)&extra[s],
                    (unsigned long long)(h + (long long)sxe * v));
        h = o.x >> 1;
        v = o.y;
      } else {
        h += o.x >> 1;
        v += o.y;
      }
    }
  }
  __syncthreads();

  // 3: the walk that writes the ids
  long long pcarry = lane < wid ? steps[lane] + extra[lane] : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) pcarry += __shfl_xor_sync(FULL_MASK, pcarry, o);
  walk_ids(e_row, c_row, nd, out, tab, dlo, R, s0, s1, pcarry, CAP_CH, sx, sy,
           lane);
}

// ---------------------------------------------------------------------------
// Kernel 3: paint_vcg
// ---------------------------------------------------------------------------

constexpr int PAINT_THREADS = 512;

// The bits one thread sets in a shared bitmap, merged while they fall in
// one word: ids that follow each other along a chain mostly do, so one
// atomicOr stands for several.
struct PendingOr {
  int w = -1;
  unsigned m = 0;
  __device__ __forceinline__ void add(unsigned* a, unsigned k) {
    const int wi = (int)(k >> 5);
    const unsigned bit = 1u << (k & 31);
    if (wi == w) {
      m |= bit;
      return;
    }
    if (m) atomicOr(&a[w], m);
    w = wi;
    m = bit;
  }
  __device__ __forceinline__ void flush(unsigned* a) {
    if (m) atomicOr(&a[w], m);
  }
};

// The 32 bits of a from bit k on; a holds the word after k's.
__device__ __forceinline__ unsigned bits_at(const unsigned* a, int k) {
  const int i = k >> 5;
  return __funnelshift_r(a[i], a[i + 1], k & 31);
}

// The 4-bit VCG of pixel j of a run of a row whose V bits start at bit 0
// of vw (pixel j reads bits j and j + 1) and whose top and bottom H bits
// start at bit 0 of ht and hb.
__device__ __forceinline__ int vcg_cell(unsigned vw, unsigned ht,
                                        unsigned hb, int j) {
  return (int)(((vw >> (j + 1)) & 1u) | (((vw >> j) & 1u) << 1) |
               (((hb >> j) & 1u) << 2) | (((ht >> j) & 1u) << 3));
}

// Replaces replay_pallas._paint_vcg_kernel and replay_big._paint_vcg_big:
// unsorted edge ids -> V/H presence bits in shared memory -> the 4-bit VCG
// V[y,x+1] | V[y,x]<<1 | H[y+1,x]<<2 | H[y,x]<<3, complemented for
// impermissible streams. No sort and no window tables are needed.
//
// What bounds it on this card: bytes, the ids read once (4 a codepoint)
// and the VCG written once (4 a pixel, eight times the ids at 512^2). The
// design, for every shape and batch: a (bands, B) grid of blocks, each
// painting the raster pixels [p0, p1) of one band of its slice, with
// enough bands that bands x B fills the card (replay.paint_grid), so that
// one slice (a CLI -T or a remote read) no longer runs on one SM. A band
// keeps only the bits its pixels read: the V ids [v0, v1) of its rows'
// span, and the H ids of its pixels' top and bottom edges, one range
// [NV + p0, NV + p1 + sx) where a row fits the band, else two of p1 - p0
// (top and bottom), so bands may cut rows and any width fits. Each block
// reads all of its slice's ids, 16 bytes a load (the bands of a slice run
// side by side, so all but the first read mostly hit L2); a warp skips
// the range checks of 128 ids whose V and H spans miss its band (on an
// H100 at B = 32 the replicated checks held the kernel to 45% of its
// bound; with the skip it reaches 52%), and merges the bits of a word
// before its atomicOr. With one band a slice (B = 512 on an H100) no
// warp skips and the grid is B blocks. It paints groups of 4 pixels with
// one 16-byte store each: within a row a group's V bits are consecutive,
// so one funnel shift reads its 5 V bits and one each its 4 top and 4
// bottom H bits. A group's (y, x) steps by a fixed stride with one
// compare, so no pixel divides; a group that wraps a row (or several,
// sx < 4) walks its pixels one by one, and at most 3 pixels at each end of
// a band that is not 16-byte aligned are written alone.
__global__ void __launch_bounds__(PAINT_THREADS)
paint_vcg_kernel(const int* __restrict__ ids, int* __restrict__ vcg, int CAP,
                 int sx, int sy, int comp, int P, int wv, int wh, int split_h,
                 int vec_ids) {
  extern __shared__ unsigned bits[];
  const int b = blockIdx.y;
  const int T = blockDim.x;
  const int sxe = sx + 1;
  const int NV = sy * sxe;
  const int n = sx * sy;
  const int p0 = blockIdx.x * P;
  const int p1 = min(p0 + P, n);
  const int y0 = p0 / sx, yl = (p1 - 1) / sx;
  const int v0 = y0 * sxe + (p0 - y0 * sx);
  const unsigned nv = (unsigned)(yl * sxe + (p1 - 1 - yl * sx) + 2 - v0);
  const unsigned np = (unsigned)(p1 - p0);
  // the H range (the top edges alone where split), and the bottom edges'
  const int h0 = NV + p0, hb0 = NV + p0 + sx;
  const unsigned nh = split_h ? np : np + sx;
  unsigned* V = bits;
  unsigned* H = bits + wv;
  unsigned* Hb = split_h ? H + wh : H;
  const int hoff = split_h ? 0 : sx;  // pixel q's bottom edge: Hb bit q + hoff
  const int words = wv + (split_h ? 2 : 1) * wh;
  for (int w = threadIdx.x; w < words; w += T) bits[w] = 0;
  __syncthreads();

  // 1: the band's bits. Unsigned differences put every id outside a
  // range (-1 too) past its length.
  PendingOr pv, ph, pb;
  auto put = [&](int e) {
    const unsigned dv = (unsigned)e - (unsigned)v0;
    if (dv < nv) pv.add(V, dv);
    const unsigned dh = (unsigned)e - (unsigned)h0;
    if (dh < nh) ph.add(H, dh);
    const unsigned db = (unsigned)e - (unsigned)hb0;
    if (split_h && db < np) pb.add(Hb, db);
  };
  const int* id = ids + (size_t)b * CAP;
  const int4* id4 = reinterpret_cast<const int4*>(id);
  const int n4 = CAP >> 2;
  if (vec_ids && gridDim.x == 1) {  // the band is the slice: every id meets it
    for (int i = threadIdx.x; i < n4; i += T) {
      const int4 q = __ldg(id4 + i);
      put(q.x);
      put(q.y);
      put(q.z);
      put(q.w);
    }
  } else if (vec_ids) {  // CAP % 4 == 0 and ids 16-byte aligned
    // A warp takes 128 consecutive ids (a stretch of a chain, so a small
    // patch of the slice), reduces their V and H spans with one redux
    // each, and puts them only where a span meets the band's: most
    // stretches miss most bands, so a band's scan costs a few
    // instructions an id, not the range checks.
    const unsigned NVu = (unsigned)NV, NBu = (unsigned)(NV + (sy + 1) * sx);
    const unsigned he = (unsigned)(NV + p1 + sx);  // past the H ranges' hull
    const int lane = threadIdx.x & 31;
    for (int w = threadIdx.x - lane; w < n4; w += T) {  // uniform in a warp
      const int i = w + lane;
      const int4 q = i < n4 ? __ldg(id4 + i) : make_int4(-1, -1, -1, -1);
      unsigned vlo = ~0u, vhi = 0, hlo = ~0u, hhi = 0;
      auto see = [&](int e) {
        const unsigned u = (unsigned)e;
        if (u < NVu) {
          vlo = min(vlo, u);
          vhi = max(vhi, u);
        } else if (u < NBu) {
          hlo = min(hlo, u);
          hhi = max(hhi, u);
        }
      };
      see(q.x);
      see(q.y);
      see(q.z);
      see(q.w);
      vlo = __reduce_min_sync(FULL_MASK, vlo);
      vhi = __reduce_max_sync(FULL_MASK, vhi);
      hlo = __reduce_min_sync(FULL_MASK, hlo);
      hhi = __reduce_max_sync(FULL_MASK, hhi);
      if ((vlo <= vhi && vhi >= (unsigned)v0 && vlo < (unsigned)v0 + nv) ||
          (hlo <= hhi && hhi >= (unsigned)h0 && hlo < he)) {
        put(q.x);
        put(q.y);
        put(q.z);
        put(q.w);
      }
    }
  } else {
    for (int i = threadIdx.x; i < CAP; i += T) put(__ldg(id + i));
  }
  pv.flush(V);
  ph.flush(H);
  pb.flush(Hb);
  __syncthreads();

  // 2: the paint
  int* out = vcg + (size_t)b * n;
  auto one = [&](int p, int y, int x) {
    const int q = p - p0;
    return vcg_cell(bits_at(V, y * sxe + x - v0), bits_at(H, q),
                    bits_at(Hb, q + hoff), 0) ^ comp;
  };
  const int mis = (int)(((size_t)b * n + p0) & 3);
  const int lo = min(p0 + ((4 - mis) & 3), p1);
  const int hi = lo + ((p1 - lo) & ~3);
  const int nhead = lo - p0;
  if (threadIdx.x < nhead + (p1 - hi)) {
    const int p = threadIdx.x < nhead ? p0 + threadIdx.x
                                      : hi + threadIdx.x - nhead;
    const int y = p / sx;
    out[p] = one(p, y, p - y * sx);
  }
  const int S = 4 * T;
  int p = lo + 4 * threadIdx.x;
  if (p >= hi) return;
  int y = p / sx, x = p - y * sx;
  const int dy = S / sx, dx = S - dy * sx;
  for (; p < hi; p += S) {
    int4 o;
    if (x + 3 < sx) {
      const int q = p - p0;
      const unsigned vw = bits_at(V, y * sxe + x - v0);
      const unsigned ht = bits_at(H, q), hb = bits_at(Hb, q + hoff);
      o = make_int4(vcg_cell(vw, ht, hb, 0) ^ comp,
                    vcg_cell(vw, ht, hb, 1) ^ comp,
                    vcg_cell(vw, ht, hb, 2) ^ comp,
                    vcg_cell(vw, ht, hb, 3) ^ comp);
    } else {
      int c[4];
      int yy = y, xx = x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = one(p + j, yy, xx);
        if (++xx == sx) {
          xx = 0;
          ++yy;
        }
      }
      o = make_int4(c[0], c[1], c[2], c[3]);
    }
    *reinterpret_cast<int4*>(out + p) = o;
    x += dx;
    y += dy;
    if (x >= sx) {
      x -= sx;
      ++y;
    }
  }
}

}  // namespace

extern "C" {

int replay_keys_launch(const void* packed, const void* nbytes,
                       const void* n_chains, void* ev, void* cls, void* drange,
                       int B, int CAP_B, int threads, int aligned,
                       void* stream) {
  replay_keys_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const int*)nbytes, (const int*)n_chains,
      (int*)ev, (int*)cls, (int*)drange, CAP_B, aligned && CAP_B % 8 == 0);
  return (int)cudaGetLastError();
}

int replay_positions_launch(const void* ev, const void* cls,
                            const void* drange, const void* nodes,
                            void* scratch, void* ids, int B, int CAP,
                            int CAP_CH, int sx, int sy, int budget, int stride,
                            int warps, void* stream) {
  const size_t smem = (size_t)warps * budget * sizeof(int2);
  cudaError_t err = cudaFuncSetAttribute(
      replay_positions_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  replay_positions_kernel<<<B, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const int*)ev, (const int*)cls, (const int*)drange, (const int*)nodes,
      (int2*)scratch, (int*)ids, CAP, CAP_CH, sx, sy, budget, stride);
  return (int)cudaGetLastError();
}

int paint_vcg_launch(const void* ids, void* vcg, int B, int CAP, int sx,
                     int sy, int permissible, int P, int bands, int wv,
                     int wh, int split_h, int vec_ids, void* stream) {
  const size_t smem = (size_t)(wv + (split_h ? 2 : 1) * wh) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      paint_vcg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  paint_vcg_kernel<<<dim3(bands, B), PAINT_THREADS, smem,
                     (cudaStream_t)stream>>>(
      (const int*)ids, (int*)vcg, CAP, sx, sy, permissible ? 0 : 0b1111, P,
      wv, wh, split_h, vec_ids);
  return (int)cudaGetLastError();
}

}  // extern "C"
