// Crack-code replay on Hopper: packed 2-bit moves -> 4-bit VCG.
//
// Three kernels, one block per slice, with a torch.sort of the keys
// between the first two. Semantics are those of
// crackle_tpu/kernels/decode.py:_decode_vcg_batch; the stage outputs
// (keys, cls, edge ids, VCG) are the contract, not the TPU's means.
//
// What bounds them on this card: every stage is a handful of integer
// operations per codepoint over (B, CAP) arrays (CAP = 32768 for a
// 512^2 slice), so they are bound by the serial chain of block-wide
// scans per tile (barriers), not by bytes or arithmetic. The design
// keeps one tile of blockDim codepoints per step, carries the scan
// state across tiles in registers, and does each scatter with plain
// atomics, where the TPU needed one-hot matmuls and sorted windows.
#include "replay.cuh"

using namespace ckl;

namespace {

__device__ __forceinline__ int diff_at(const uint8_t* pk, int i) {
  return (pk[i >> 2] >> (2 * (i & 3))) & 3;
}

// Kernel 1. Replaces replay_pallas._keys_kernel and
// replay_big._keys_kernel_big: 2-bit diffs -> mod-4 cumsum codepoints
// -> move/branch/terminate classes, chain ids and scope depth -> one
// int64 sort key per codepoint, (depth*CAP + pos) << 3 | close << 2 |
// cps (INT64_MAX when inactive), and a cls word cps | move << 2 |
// chain << 3. Tiles of blockDim codepoints carry the eight values of
// replay_big._carr_init; the pair-second state of the codepoint after
// a tile follows from s[i+1] = r[i+1] & ~s[i], so no lookahead row.
__global__ void replay_keys_kernel(const uint8_t* __restrict__ packed,
                                   const int* __restrict__ nbytes,
                                   const int* __restrict__ n_chains,
                                   long long* __restrict__ keys,
                                   int* __restrict__ cls, int CAP_B) {
  __shared__ int warp[MAX_WARPS];
  __shared__ int buf[1024];
  __shared__ int carry[8];
  const int b = blockIdx.x;
  const int T = blockDim.x;
  const int CAP = CAP_B * 4;
  const uint8_t* pk = packed + (size_t)b * CAP_B;
  long long* kout = keys + (size_t)b * CAP;
  int* cout = cls + (size_t)b * CAP;
  const int n_cps = nbytes[b] * 4;
  const int nch = n_chains[b];
  const int chmax = max(nch - 1, 0);

  int cps_c = 0, prev_c = 255, r_c = 0, rs_c = -1;
  int c_c = 0, cm_c = INT_MAX, ie_c = 0, ec_c = 0;
  for (int t0 = 0; t0 < CAP; t0 += T) {
    const int i = t0 + threadIdx.x;
    const bool inr = i < n_cps;
    int tot;
    const int d = inr ? diff_at(pk, i) : 0;
    const int cps = (block_scan(d, 0, Add(), warp, &tot) + cps_c) & 3;
    const int prev = shift_prev(cps, prev_c, buf);
    const int r = inr && ((cps ^ prev) == 2);
    const int r_prev = shift_prev(r, r_c, buf);
    const int rs = (r && !r_prev) ? i : -1;
    const int run_start =
        max(block_scan(r ? rs : -1, INT_MIN, Max(), warp, &tot), rs_c);
    const int second = r && (((i - run_start) & 1) == 0);

    const bool inr1 = i + 1 < n_cps;
    const int cps1 = (cps + (inr1 ? diff_at(pk, i + 1) : 0)) & 3;
    const int r1 = inr1 && ((cps1 ^ cps) == 2);
    const int pair_first = r1 && !second;
    const int term_pair = cps1 == 0 || cps1 == 3;
    const int is_term = pair_first && term_pair;
    const int is_branch = pair_first && !term_pair;
    const int is_move = !pair_first && !second && inr;

    const int c = block_scan(is_branch - is_term, 0, Add(), warp, &tot) + c_c;
    const int cm = min(block_scan(c, INT_MAX, Min(), warp, &tot), cm_c);
    const int runmin = min(shift_prev(cm, cm_c, buf), 0);
    const int is_end = inr && (c < runmin);
    const int end_cum = block_scan(is_end, 0, Add(), warp, &tot) + ec_c;
    const int cnt_before = end_cum - is_end;
    const int chain_of = min(max(cnt_before, 0), chmax);
    const int prev_is_end = shift_prev(is_end, ie_c, buf);
    const int valid = (cnt_before < nch) || prev_is_end;

    if (i < CAP) {
      const long long depth = (long long)c + chain_of + 1 + is_term;
      const int close = is_term && valid;
      const int active = valid && (is_move || is_term);
      kout[i] = active ? (((depth * CAP + i) * 8) | (close << 2) | cps)
                       : LLONG_MAX;
      cout[i] = cps | ((is_move && valid) << 2) | (chain_of << 3);
    }
    if (threadIdx.x == T - 1) {
      carry[0] = cps; carry[1] = r; carry[2] = run_start; carry[3] = c;
      carry[4] = cm; carry[5] = is_end; carry[6] = end_cum;
    }
    __syncthreads();
    cps_c = prev_c = carry[0]; r_c = carry[1]; rs_c = carry[2];
    c_c = carry[3]; cm_c = carry[4]; ie_c = carry[5]; ec_c = carry[6];
    __syncthreads();
  }
}

// Kernel 2. Replaces replay_pallas._replay_kernel and replay_big's
// _scope_kernel and _replay_kernel_big. Over the sorted keys, a
// reverse tiled scan finds each move's next close at the same depth;
// the tile seam carries the scan value, and the depth-segment end
// reads the next key itself, so a seam fakes no boundary. Each move
// atomically adds its +-1 at that close into a (2, CAP) H/V cancel
// buffer. After a barrier, replay_forward (replay.cuh) turns deltas,
// cancels and chain bases into every move's edge id.
__global__ void replay_positions_kernel(const long long* __restrict__ skeys,
                                        const int* __restrict__ cls,
                                        const int* __restrict__ nodes,
                                        int* __restrict__ cancel,
                                        int* __restrict__ ids, int CAP,
                                        int CAP_CH, int sx, int sy) {
  __shared__ int warp[MAX_WARPS];
  const int b = blockIdx.x;
  const int T = blockDim.x;
  const long long* sk = skeys + (size_t)b * CAP;
  int* can = cancel + (size_t)b * 2 * CAP;
  const int logcap = 31 - __clz(CAP);
  for (int i = threadIdx.x; i < 2 * CAP; i += T) can[i] = 0;
  __syncthreads();

  int carry = -1;
  const int ntile = (CAP + T - 1) / T;
  for (int k = ntile - 1; k >= 0; --k) {
    const int j = k * T + (T - 1 - threadIdx.x);  // reversed in the tile
    int e = -1, cps = 0;
    bool move = false;
    if (j < CAP) {
      const long long key = sk[j];
      const bool inf = key == LLONG_MAX;
      const bool close = !inf && ((key >> 2) & 1);
      const long long body = key >> 3;
      const long long depth = body >> logcap;
      bool seg_last = inf || j == CAP - 1;
      if (!seg_last) {
        const long long nk = sk[j + 1];
        seg_last = nk == LLONG_MAX || ((nk >> 3) >> logcap) != depth;
      }
      if (close || seg_last) e = close ? (int)(body & (CAP - 1)) : CAP;
      move = !inf && !close;
      cps = (int)(key & 3);
    }
    int tot;
    int nc = block_scan(e, -1, LastSet(), warp, &tot);
    if (nc < 0) nc = carry;
    carry = tot >= 0 ? tot : carry;
    if (move && nc >= 0 && nc < CAP) {
      const bool isV = cps == 0 || cps == 2;
      atomicAdd(&can[(isV ? CAP : 0) + nc], (cps == 3 || cps == 0) ? 1 : -1);
    }
  }
  __syncthreads();

  __shared__ long long warpl[MAX_WARPS];
  replay_forward(cls + (size_t)b * CAP, nodes + (size_t)b * CAP_CH, can,
                 ids + (size_t)b * CAP, CAP, CAP_CH, sx, sy, warpl);
}

// Kernel 3. Replaces replay_pallas._paint_vcg_kernel and
// replay_big._paint_vcg_big: unsorted edge ids -> V/H presence bits in
// shared memory (atomicOr; 64 KB for a 512^2 slice) -> the 4-bit VCG
// V[y,x+1] | V[y,x]<<1 | H[y+1,x]<<2 | H[y,x]<<3, complemented for
// impermissible streams. No sort and no window tables are needed.
__global__ void paint_vcg_kernel(const int* __restrict__ ids,
                                 int* __restrict__ vcg, int CAP, int sx,
                                 int sy, int permissible) {
  extern __shared__ unsigned bits[];
  const int b = blockIdx.x;
  const int T = blockDim.x;
  const int sxe = sx + 1;
  const int NV = sy * sxe;
  const int NB = NV + (sy + 1) * sx;
  const int nwords = (NB + 31) >> 5;
  for (int w = threadIdx.x; w < nwords; w += T) bits[w] = 0;
  __syncthreads();
  const int* id = ids + (size_t)b * CAP;
  for (int i = threadIdx.x; i < CAP; i += T) {
    const int e = id[i];
    if (e >= 0 && e < NB) atomicOr(&bits[e >> 5], 1u << (e & 31));
  }
  __syncthreads();
  const int n = sx * sy;
  const int comp = permissible ? 0 : 0b1111;
  int* out = vcg + (size_t)b * n;
  for (int p = threadIdx.x; p < n; p += T) {
    const int y = p / sx;
    const int x = p - y * sx;
    auto bit = [&](int k) { return (int)((bits[k >> 5] >> (k & 31)) & 1u); };
    const int v = bit(y * sxe + x + 1) | (bit(y * sxe + x) << 1) |
                  (bit(NV + (y + 1) * sx + x) << 2) | (bit(NV + y * sx + x) << 3);
    out[p] = v ^ comp;
  }
}

}  // namespace

extern "C" {

int replay_keys_launch(const void* packed, const void* nbytes,
                       const void* n_chains, void* keys, void* cls, int B,
                       int CAP_B, int tile, void* stream) {
  replay_keys_kernel<<<B, tile, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const int*)nbytes, (const int*)n_chains,
      (long long*)keys, (int*)cls, CAP_B);
  return (int)cudaGetLastError();
}

int replay_positions_launch(const void* skeys, const void* cls,
                            const void* nodes, void* cancel, void* ids, int B,
                            int CAP, int CAP_CH, int sx, int sy, int tile,
                            void* stream) {
  replay_positions_kernel<<<B, tile, 0, (cudaStream_t)stream>>>(
      (const long long*)skeys, (const int*)cls, (const int*)nodes,
      (int*)cancel, (int*)ids, CAP, CAP_CH, sx, sy);
  return (int)cudaGetLastError();
}

int paint_vcg_launch(const void* ids, void* vcg, int B, int CAP, int sx,
                     int sy, int permissible, void* stream) {
  const int NB = sy * (sx + 1) + (sy + 1) * sx;
  const size_t smem = (size_t)((NB + 31) >> 5) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      paint_vcg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  paint_vcg_kernel<<<B, 1024, smem, (cudaStream_t)stream>>>(
      (const int*)ids, (int*)vcg, CAP, sx, sy, permissible);
  return (int)cudaGetLastError();
}

}  // extern "C"
