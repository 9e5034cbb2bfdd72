// The compact-cancel replay on Hopper: event words -> per-close cancel
// sums in the reference's sorted order -> compact close tables -> edge
// ids.
//
// An alternative to replay_positions (replay.cu) for the cancels, kept
// as the counterpart of the reference's compact-cancel path
// (replay_big.py:878-980): each close gets the sum of the moves of its
// run, and the replay adds the sums at the close positions. Each
// move's next close is the close whose run holds it, so the edge ids
// equal replay_positions' element by element; that equality, and the
// dense records in the reference's sorted (depth, position) order, not
// the TPU's means, are the contract. The reference sorts int64 keys for
// that order; here no sort runs: cancel_sums finds each event's slot
// in it from per-depth counts of the same forward walk that gives the
// run sums (replay.cuh).
//
// What bounds them on this card: bytes would allow 120 us (cancel_sums)
// and 46 us (the replay) at B = 512 slices of CAP 32768. cancel_sums is
// held back by its two walks, whose warp steps issue one after another
// (the designs below cut each slice into 32 warp segments), and by its
// scattered stores; the replay by its arithmetic per position (the
// edge ids), which a scan of 16 positions a thread keeps short. The
// compaction
// is bound by bytes: the dest plane is read once (4 bytes a slot), a
// close's pos and sums once, and the tables written once. At one block
// per slice it sat on load latency (32 of 132 SMs busy at B = 32, one
// dependent 4-byte load per thread per round), so it runs on a (chunks,
// B) grid of 16-byte loads; see kernel i.
#include "replay.cuh"

using namespace ckl;

namespace {

// Calls f(i, e, c) for each position i of a warp's segment [s0, s1), 32
// a step, with its event word e and cls word c (0 past s1), the next
// step's words loaded ahead.
template <class F>
__device__ __forceinline__ void for_steps(const int* __restrict__ e_row,
                                          const int* __restrict__ c_row,
                                          int s0, int s1, int lane, F f) {
  int e_nx = s0 + lane < s1 ? e_row[s0 + lane] : 0;
  int c_nx = s0 + lane < s1 ? c_row[s0 + lane] : 0;
  for (int t0 = s0; t0 < s1; t0 += 32) {
    const int i = t0 + lane;
    const int e = e_nx, c = c_nx;
    if (i + 32 < s1) {
      e_nx = e_row[i + 32];
      c_nx = c_row[i + 32];
    }
    f(i, e, c);
  }
}

// Kernel h. Replaces replay_big._cancel_sums_kernel, which scans the
// sorted keys. Writes dense records per slot of the sorted order: dest
// (the close's rank, -1 elsewhere), pos (the event's stream position;
// CAP - 1 past the active events, as the INT64_MAX keys give), sumH and
// sumV (a close's run sums, 0 elsewhere). Without a sort: an active
// event at depth d and position p has the slot E_lt[d] + e_before(d, p)
// (the slice's events at depths below d, then those of depth d before
// p), a close the rank C_lt[d] + c_before(d, p), and a close's run sums
// are depth d's pending sums when the walk reaches it.
//
// One block a slice, in the layout of replay_positions: where the
// slice's depth range fits `budget` entries, its warps split it into
// segments, one each, with int4 tables in shared memory ({2h + closed,
// v, events, closes}, 16 bytes an entry: 192 KB at 32 warps of 384):
//   1. each warp walks its segment from empty tables: per depth, the
//      pending sums and the events and closes it holds;
//   2. per depth, one thread carries the pending sums and the counts
//      over the segments in order, so each segment's entry holds what
//      is pending and counted at its start; an exclusive scan over the
//      depths (events and closes in one 64-bit word) adds E_lt and C_lt;
//      pos is set to CAP - 1 from the slice's event count up;
//   3. each warp walks its segment again, and each active lane stores
//      its position at its slot, and a close its rank and sums: a warp
//      step's lanes of one depth store to consecutive slots.
// These stores scatter over the slice's rows; the dest, sumH and sumV
// rows are set as off a close in step 1, 32 coalesced slots a warp step
// (a fill of the rows before step 1 cost more: all warps stored at
// once), so only the pos row and the closes' records (few: a close ends
// a depth's run of moves) scatter.
// Otherwise (a corrupt stream's range; the budget's shrunk in tests)
// warp 0 walks the slice with its table in the slice's row of `scratch`
// (stride entries) and the block runs step 2 on it.
__global__ void __launch_bounds__(1024)
cancel_sums_kernel(const int* __restrict__ ev, const int* __restrict__ cls,
                   const int* __restrict__ drange, int4* __restrict__ scratch,
                   int* __restrict__ dest, int* __restrict__ pos,
                   int* __restrict__ sumh, int* __restrict__ sumv, int CAP,
                   int budget, int stride) {
  extern __shared__ int4 tabs4[];
  __shared__ unsigned long long warp64[MAX_WARPS];
  const int b = blockIdx.x;
  const int T = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const size_t row = (size_t)b * CAP;
  const int* e_row = ev + row;
  const int* c_row = cls + row;
  const int dlo = drange[2 * b];
  const int R = min(max(drange[2 * b + 1] - dlo + 1, 0), stride);

  const bool wide = R > budget;
  const int nseg = wide ? 1 : T >> 5;
  int4* tab0 = wide ? scratch + (size_t)b * stride : tabs4;
  // entries from one segment's table to the next
  const int tstep = wide ? 0 : budget;
  int4* tab = tab0 + (size_t)wid * tstep;
  const int L = (CAP + nseg - 1) / nseg;
  const int s0 = min(wid * L, CAP), s1 = min(s0 + L, CAP);
  const bool walker = wid < nseg;
  if (wide) {
    for (int k = threadIdx.x; k < R; k += T) tab0[k] = make_int4(0, 0, 0, 0);
  } else {
    for (int k = lane; k < R; k += 32) tab[k] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();

  // 1: the local walk; the segments tile the slice, so each warp sets
  // its segment's slots of dest, sumH and sumV as off a close on the way
  if (walker) {
    for_steps(e_row, c_row, s0, s1, lane, [&](int i, int e, int c) {
      if (i < s1) {
        dest[row + i] = -1;
        sumh[row + i] = 0;
        sumv[row + i] = 0;
      }
      walk_step(e, c, tab, dlo, R, lane);
    });
  }
  __syncthreads();

  // 2: the sums and counts at each segment's start, then the depths
  // below each depth
  // events | closes << 32 at the depths below this round's
  unsigned long long below = 0;
  for (int k0 = 0; k0 < R; k0 += T) {
    const int k = k0 + threadIdx.x;
    unsigned long long n = 0;
    if (k < R) {
      int h = 0, v = 0, ne = 0, nc = 0;
      for (int s = 0; s < nseg; ++s) {
        int4* q = tab0 + (size_t)s * tstep + k;
        const int4 o = *q;
        *q = make_int4(2 * h, v, ne, nc);
        if (o.x & 1) {
          h = o.x >> 1;
          v = o.y;
        } else {
          h += o.x >> 1;
          v += o.y;
        }
        ne += o.z;
        nc += o.w;
      }
      n = (unsigned)ne | ((unsigned long long)nc << 32);
    }
    unsigned long long tot;
    const unsigned long long lt =
        below + block_scan_excl(n, 0ull, Add(), warp64, &tot);
    if (k < R) {
      for (int s = 0; s < nseg; ++s) {
        int4* q = tab0 + (size_t)s * tstep + k;
        q->z += (int)(lt & 0xffffffffu);
        q->w += (int)(lt >> 32);
      }
    }
    below += tot;
  }
  const int n_active = (int)(below & 0xffffffffu);
  for (int j = n_active + threadIdx.x; j < CAP; j += T) pos[row + j] = CAP - 1;
  __syncthreads();

  // 3: the walk that writes the records
  if (walker) {
    for_steps(e_row, c_row, s0, s1, lane, [&](int i, int e, int c) {
      const WalkOut w = walk_step(e, c, tab, dlo, R, lane);
      const int k = (e >> 2) - dlo;
      if ((e & 1) && k >= 0 && k < R) {
        const size_t at = row + w.slot;
        pos[at] = i;
        if ((e >> 1) & 1) {
          dest[at] = w.rank;
          sumh[at] = w.cancel.x;
          sumv[at] = w.cancel.y;
        }
      }
    });
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

// Kernel j. Replaces replay_big._replay_kernel_compact. The cancels
// stay in shared memory: a block takes a window of `window` positions of
// one slice, one 64-bit value a position (the close's H + (sx + 1) V
// sums, 0 elsewhere, so the scan adds one value), filled by one pass
// over the slice's table entries in 16-byte loads, four a thread issued
// together (positions are unique within a slice, so plain stores do it;
// the reference's sort of the tables by position only windowed the
// TPU's scatter, and is dropped). Then the 64-bit position scan, with
// each thread on RJ_PER consecutive positions: their cls words in
// 16-byte loads, a serial running sum written back over the values,
// one warp scan of the threads' sums, warp 0's scan of the warp sums
// and the window's carry, then each position's edge id from its running
// sum and its thread's carry, stored 16 bytes at a time (a warp scan
// for every 32 positions, ten shuffles each, ran slower, the more so
// with a warp's steps held in registers). The window's values lie at
// p + p / RJ_PER (a pad word every RJ_PER), so that a warp's threads,
// RJ_PER + 1 words apart, read them from different banks. Three
// barriers a window.
//
// Grid: one block a window of every slice, B * chunks blocks, so B = 32
// slices of CAP 32768 fill the card. A block draws a ticket (the
// slice-major order of its window) from state[0] as it starts, and takes
// the carry of the positions before its window by a decoupled look-back
// over the slice's earlier windows: each publishes its sum as soon as it
// has it (flag 1), and its inclusive prefix once it knows it (flag 2),
// in one 64-bit word, value << 2 | flag. A window waits only on windows
// with smaller tickets, which have started and publish without waiting,
// so the look-back cannot deadlock. `state` is 1 + B * chunks zeroed
// words from the wrapper. CAP is at least RJ_PER (the wrapper checks),
// so a thread's positions lie all in its window or all past its end.
constexpr int RJ_PER = 16;  // consecutive positions a thread takes
constexpr int RJ_THREADS = 512;  // the most threads a block (window 8192)

__host__ __device__ __forceinline__ int rj_at(int p) { return p + p / RJ_PER; }

__device__ __forceinline__ void publish(unsigned long long* w, long long v,
                                        int flag) {
  atomicExch(w, ((unsigned long long)v << 2) | (unsigned)flag);
}

__global__ void __launch_bounds__(RJ_THREADS, 2)
replay_positions_compact_kernel(
    const int* __restrict__ cls, const int* __restrict__ cpos,
    const int* __restrict__ csumh, const int* __restrict__ csumv,
    const int* __restrict__ nodes, unsigned long long* __restrict__ state,
    int* __restrict__ ids, int CAP, int CCAP, int CAP_CH, int sx, int sy,
    int window, int chunks) {
  extern __shared__ long long can[];
  __shared__ long long wsum[MAX_WARPS];
  __shared__ long long carry;
  __shared__ int ticket;
  const int T = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = T >> 5;
  if (threadIdx.x == 0) ticket = (int)atomicAdd(state, 1ull);
  for (int i = threadIdx.x; i < rj_at(window); i += T) can[i] = 0;
  __syncthreads();
  const int b = ticket / chunks;
  const int ch = ticket - b * chunks;
  const int w0 = ch * window;
  const int w1 = min(w0 + window, CAP);
  const int sxe = sx + 1;
  const size_t row = (size_t)b * CAP;
  const int* cp = cpos + (size_t)b * CCAP;
  const int* chh = csumh + (size_t)b * CCAP;
  const int* cvv = csumv + (size_t)b * CCAP;
  const int* nd = nodes + (size_t)b * CAP_CH;

  // the window's cancels: CCAP is a multiple of 4 and the table rows are
  // 16-byte aligned (the wrapper checks)
  for (int r0 = 16 * threadIdx.x; r0 < CCAP; r0 += 16 * T) {
    int4 q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      q[u] = r0 + 4 * u < CCAP ? __ldg((const int4*)(cp + r0 + 4 * u))
                               : make_int4(-1, -1, -1, -1);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pp[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int p = pp[v], r = r0 + 4 * u + v;
        if (p >= w0 && p < w1)
          can[rj_at(p - w0)] = __ldg(chh + r) + (long long)sxe * __ldg(cvv + r);
      }
    }
  }
  __syncthreads();

  // this thread's positions [p0, p0 + RJ_PER): the running sum
  const int p0 = w0 + RJ_PER * threadIdx.x;
  const bool mine = p0 < w1;
  long long* run = can + rj_at(p0 - w0);
  int c[RJ_PER];
  long long sum = 0;
  if (mine) {
#pragma unroll
    for (int u = 0; u < RJ_PER / 4; ++u) {
      const int4 q = __ldg((const int4*)(cls + row + p0) + u);
      c[4 * u] = q.x;
      c[4 * u + 1] = q.y;
      c[4 * u + 2] = q.z;
      c[4 * u + 3] = q.w;
    }
#pragma unroll
    for (int k = 0; k < RJ_PER; ++k) {
      sum += ((c[k] >> 2) & 1 ? move_delta(c[k] & 3, sxe) : 0) + run[k];
      run[k] = sum;
    }
  }
  long long incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long n = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) wsum[wid] = incl;
  __syncthreads();

  if (wid == 0) {
    const long long w = lane < nw ? wsum[lane] : 0;
    long long wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long n = __shfl_up_sync(FULL_MASK, wi, o);
      if (lane >= o) wi += n;
    }
    if (lane < nw) wsum[lane] = wi - w;
    const long long agg = __shfl_sync(FULL_MASK, wi, 31);
    if (lane == 0) {
      long long before = 0;
      if (chunks > 1) {
        unsigned long long* st = state + 1 + (size_t)b * chunks;
        if (ch == 0) {
          publish(st, agg, 2);
        } else {
          publish(st + ch, agg, 1);
          for (int k = ch - 1; k >= 0; --k) {
            unsigned long long x;
            do {
              x = *(volatile unsigned long long*)(st + k);
            } while ((x & 3) == 0);
            before += (long long)x >> 2;
            if ((x & 3) == 2) break;
          }
          publish(st + ch, before + agg, 2);
        }
      }
      carry = before;
    }
  }
  __syncthreads();

  if (mine) {
    const long long pc = carry + wsum[wid] + incl - sum;
    int id[RJ_PER];
#pragma unroll
    for (int k = 0; k < RJ_PER; ++k) {
      const int cps = c[k] & 3;
      id[k] = -1;
      if ((c[k] >> 2) & 1) {
        const int chain = c[k] >> 3;
        const long long base = chain >= 0 && chain < CAP_CH ? nd[chain] : 0;
        id[k] = edge_id(pc + run[k] + base - move_delta(cps, sxe), cps, sx,
                        sy);
      }
    }
#pragma unroll
    for (int u = 0; u < RJ_PER / 4; ++u)
      *((int4*)(ids + row + p0) + u) =
          make_int4(id[4 * u], id[4 * u + 1], id[4 * u + 2], id[4 * u + 3]);
  }
}

}  // namespace

extern "C" {

int cancel_sums_launch(const void* ev, const void* cls, const void* drange,
                       void* scratch, void* dense, int B, int CAP,
                       int budget, int stride, int warps, void* stream) {
  int* d = (int*)dense;  // (4, B, CAP): dest, pos, sumH, sumV
  const size_t plane = (size_t)B * CAP;
  const size_t smem = (size_t)warps * budget * sizeof(int4);
  cudaError_t err = cudaFuncSetAttribute(
      cancel_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cancel_sums_kernel<<<B, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const int*)ev, (const int*)cls, (const int*)drange, (int4*)scratch, d,
      d + plane, d + 2 * plane, d + 3 * plane, CAP, budget, stride);
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
                                    const void* nodes, void* state, void* ids,
                                    int B, int CAP, int CCAP, int CAP_CH,
                                    int sx, int sy, int window, void* stream) {
  const int* t = (const int*)tables;
  const size_t tplane = (size_t)B * CCAP;
  const int chunks = (CAP + window - 1) / window;
  int threads = window / RJ_PER;  // RJ_PER positions a thread
  threads = threads < 32 ? 32 : threads > RJ_THREADS ? RJ_THREADS : threads;
  const size_t smem = (size_t)rj_at(window) * sizeof(long long);
  cudaError_t err = cudaFuncSetAttribute(
      replay_positions_compact_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  replay_positions_compact_kernel<<<B * chunks, threads, smem,
                                    (cudaStream_t)stream>>>(
      (const int*)cls, t, t + tplane, t + 2 * tplane, (const int*)nodes,
      (unsigned long long*)state, (int*)ids, CAP, CCAP, CAP_CH, sx, sy, window,
      chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
