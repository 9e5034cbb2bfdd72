// Kernel 11: CRC32C of each row of a (B, W) int32 word tensor (the
// little-endian u32 message of 4W bytes), and the CRC gate's comparison
// with each row's stored word.
//
// Replaces crc32c_tpu.py's XLA path (crc32c_words_traced): no Pallas
// kernel computed the CRC on the TPU, where a block table of bit planes
// and a log-depth fold of GF(2) products suited the matrix unit. Its
// plain tensor version (kernels/crc32c.py) spends 32 bit-plane passes of
// int64 words and one float GEMM a plane; on this card that is some 16
// bytes of traffic a word, 32 times over.
//
// What bounds it on this card: bytes. The ids are read once, 4 bytes a
// word: 512 MiB for 512 slices of 512^2, 0.16 ms at 3.35 TB/s. A table-
// driven CRC costs 4 byte lookups a word; unless those lookups keep off
// each other's shared-memory banks they, and not the memory, set the
// pace. So:
// - R0(m), the register after m is folded into a zero register, is
//   linear, and R0(m1 ++ m2) = A^len(m2)(R0(m1)) ^ R0(m2), A advancing
//   the register by one zero byte. A slice's message is cut into chunks
//   of G groups of GROUP = 128 words, aligned to the message's end (the
//   first chunk starts before the message, where words read as zeros:
//   leading zeros leave R0 unchanged, and the true length enters only
//   through c0 = crc of W zero words);
// - a warp takes a chunk. In each group lane l reads words 4l .. 4l + 3
//   with one 16-byte load (the warp reads 512 consecutive bytes) and
//   folds them into its register after advancing it over the other
//   lanes' 124 words: acc = A^16(A^496(acc)) ^ R0(4 words), which is 4
//   lookups for A^496 and 16 for the words, about 5 a word. At the
//   chunk's end lane l advances its register by the 16 (31 - l) bytes
//   after its last words (32 columns of a lane's own matrix) and the
//   warp XORs the lanes' registers;
// - an advance A^n(r) is the XOR of 4 lookups, one a byte of r, in byte
//   tables [i][p] = A^n(i << 8p) (the slicing-by-4 tables are those of
//   A^4: folding a word w into r is A^4(r ^ w)). Each of the two table
//   sets lives in shared memory 8 times over, slot p of copy a in bank
//   4a + p, and lane 4a + c looks the bytes up in the order p = (k + c)
//   mod 4, k = 0..3: at every step the warp's 32 lookups fall in 32
//   banks. 64 KB of tables, against 128 KB for 32 copies;
// - a second kernel, a warp a slice, combines the chunks' registers
//   (lane l takes chunks l, l + 32, ... from the message's end, a Horner
//   step of A^(4 x chunk bytes x 32) each, then its own advance), adds c0,
//   and, for the gate, compares with the stored word and keeps the least
//   mismatching row in first_bad, which the first kernel set to B.
// The chunk length G is the wrapper's (crc32c.chunk_groups): the largest
// power of two that leaves about CRC_FILL warps of work an SM.
#include "common.cuh"

using namespace ckl;

namespace {

constexpr int CRC_THREADS = 512;
constexpr int CRC_WARPS = CRC_THREADS / 32;
constexpr int RUN = 4;             // consecutive words of a lane a group
constexpr int GROUP = 32 * RUN;    // words of a warp's group
constexpr int TABLE_UINT4 = 256;   // one byte-table set, [i][p], as uint4
constexpr int COPIES = 8;          // copies of a table set in shared memory
constexpr int SET_BYTES = TABLE_UINT4 * COPIES * 16;  // 32 KB
// shared memory: the A^4 set, the A^(4 (GROUP - RUN)) set, and the
// (32 bits, 32 lanes) columns of each lane's advance to its group's end
constexpr int CRC_SMEM = 2 * SET_BYTES + 32 * 32 * 4;

// A^n(r) from a set of byte tables laid out in banks: byte p of r
// indexes slot p, at byte i * 128 + (4a + p) * 4 of the set for copy a.
// rot and off are the lane's: at step k it takes p = (k + lane) mod 4,
// rotates byte p of r to bits 7..14 and adds its copy's slot.
__device__ __forceinline__ unsigned advance(const unsigned char* set,
                                            unsigned r, const unsigned* rot,
                                            const unsigned* off) {
  unsigned v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = *(const unsigned*)(set + ((__funnelshift_r(r, r, rot[k]) &
                                      0x7f80u) | off[k]));
  return (v[0] ^ v[1]) ^ (v[2] ^ v[3]);
}

// Words q .. q + 3 of a row, zeros before the message (q < 0). With VEC
// every q is a multiple of 4 and the row 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ uint4 load_run(const int* __restrict__ row,
                                          long long q) {
  if (VEC) {
    if (q < 0) return make_uint4(0u, 0u, 0u, 0u);
    return __ldg(reinterpret_cast<const uint4*>(row + q));
  }
  unsigned v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = q + k >= 0 ? (unsigned)__ldg(row + q + k) : 0u;
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// grid (ceil(B * nchunks / CRC_WARPS)); a warp a (slice, chunk) task,
// writing the chunk's R0 to part[b * nchunks + c]. tables: the A^4 and
// A^(4 (GROUP - RUN)) byte tables, TABLE_UINT4 uint4 each, then the
// lanes' 1024 columns.
template <bool VEC>
__global__ void __launch_bounds__(CRC_THREADS, 2)
crc32c_chunks_kernel(const int* __restrict__ words,
                     const uint4* __restrict__ tables,
                     unsigned* __restrict__ part, int* __restrict__ first_bad,
                     int B, int W, int nchunks, int G) {
  extern __shared__ uint4 smem4[];
  for (int k = threadIdx.x; k < 2 * TABLE_UINT4 * COPIES; k += blockDim.x) {
    const int set = k / (TABLE_UINT4 * COPIES);
    const int i = (k / COPIES) % TABLE_UINT4;
    // uint4 i * 8 + a of a set: slots 0..3 of entry i in banks 4a .. 4a+3
    smem4[k] = __ldg(tables + set * TABLE_UINT4 + i);
  }
  for (int k = threadIdx.x; k < 32 * 32 / 4; k += blockDim.x)
    smem4[2 * TABLE_UINT4 * COPIES + k] = __ldg(tables + 2 * TABLE_UINT4 + k);
  if (first_bad && blockIdx.x == 0 && threadIdx.x == 0) *first_bad = B;
  __syncthreads();

  const long long t = (long long)blockIdx.x * CRC_WARPS + (threadIdx.x >> 5);
  if (t >= (long long)B * nchunks) return;  // warp-uniform
  const unsigned char* fold = (const unsigned char*)smem4;
  const unsigned char* skip = fold + SET_BYTES;
  const unsigned* cols = (const unsigned*)(fold + 2 * SET_BYTES);
  const int lane = threadIdx.x & 31;
  unsigned rot[4], off[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned p = (k + lane) & 3;
    rot[k] = (8 * p - 7) & 31;
    off[k] = (4 * (lane >> 2) + p) * 4;
  }

  const int b = (int)(t / nchunks);
  const long long cw = (long long)G * GROUP;
  // message index of the lane's first word in the chunk's first group
  long long q = (t % nchunks) * cw - ((long long)nchunks * cw - W) +
                lane * RUN;
  const int* row = words + (long long)b * W;
  // two groups in flight while a third is folded
  uint4 w0 = load_run<VEC>(row, q);
  uint4 w1 = G > 1 ? load_run<VEC>(row, q + GROUP) : make_uint4(0, 0, 0, 0);
  unsigned acc = 0;
  for (int g = 0; g < G; ++g) {
    const uint4 w2 = g + 2 < G ? load_run<VEC>(row, q + 2 * GROUP)
                               : make_uint4(0u, 0u, 0u, 0u);
    unsigned r = advance(skip, acc, rot, off) ^ w0.x;
    r = advance(fold, r, rot, off) ^ w0.y;
    r = advance(fold, r, rot, off) ^ w0.z;
    r = advance(fold, r, rot, off) ^ w0.w;
    acc = advance(fold, r, rot, off);
    w0 = w1;
    w1 = w2;
    q += GROUP;
  }
  // the lane's words end 16 (31 - lane) bytes before the chunk's end
  unsigned v = 0;
#pragma unroll
  for (int bit = 0; bit < 32; ++bit)
    v ^= (acc >> bit & 1u) ? cols[bit * 32 + lane] : 0u;
#pragma unroll
  for (int o = 16; o; o >>= 1) v ^= __shfl_xor_sync(FULL_MASK, v, o);
  if (lane == 0) part[t] = v;
}

// grid (ceil(B / 8)), a warp a slice. ctab: the byte tables [i][p] of
// A^(4 chunk words x 32) as 1024 words, then the (32 bits, 32 lanes)
// columns of A^(4 chunk words x lane). stored and first_bad may be null.
__global__ void __launch_bounds__(256)
crc32c_combine_kernel(const unsigned* __restrict__ part,
                      const unsigned* __restrict__ ctab,
                      const long long* __restrict__ stored,
                      long long* __restrict__ crc, int* __restrict__ first_bad,
                      int B, int nchunks, unsigned c0) {
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const unsigned* p = part + (long long)b * nchunks;
  // lane l folds the chunks l + 32 j from the message's end, j from the
  // last down, a chunk-length advance of 32 chunks between them
  unsigned acc = 0;
  for (int j = (nchunks - 1) >> 5; j >= 0; --j) {
    acc = __ldg(ctab + (acc & 0xff) * 4) ^
          __ldg(ctab + (acc >> 8 & 0xff) * 4 + 1) ^
          __ldg(ctab + (acc >> 16 & 0xff) * 4 + 2) ^
          __ldg(ctab + (acc >> 24) * 4 + 3);
    const int e = lane + 32 * j;
    if (e < nchunks) acc ^= __ldg(p + nchunks - 1 - e);
  }
  unsigned v = 0;
#pragma unroll
  for (int bit = 0; bit < 32; ++bit)
    v ^= (acc >> bit & 1u) ? __ldg(ctab + 1024 + bit * 32 + lane) : 0u;
#pragma unroll
  for (int o = 16; o; o >>= 1) v ^= __shfl_xor_sync(FULL_MASK, v, o);
  if (lane == 0) {
    const unsigned c = v ^ c0;
    crc[b] = (long long)c;
    if (stored && stored[b] != (long long)c) atomicMin(first_bad, b);
  }
}

}  // namespace

// words (B, W) int32; tables, ctab as above; part (B * nchunks) scratch;
// crc (B,) int64 out; stored (B,) int64 and first_bad (1,) int32, or both
// null. vec: W % 4 == 0 and words 16-byte aligned.
extern "C" int crc32c_rows_launch(const void* words, const void* tables,
                                  const void* ctab, void* part,
                                  const void* stored, void* crc,
                                  void* first_bad, int B, int W, int nchunks,
                                  int G, int vec, unsigned c0, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long blocks =
      ((long long)B * nchunks + CRC_WARPS - 1) / CRC_WARPS;
  auto kernel = vec ? crc32c_chunks_kernel<true> : crc32c_chunks_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CRC_SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, CRC_THREADS, CRC_SMEM, s>>>(
      (const int*)words, (const uint4*)tables, (unsigned*)part,
      (int*)first_bad, B, W, nchunks, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  crc32c_combine_kernel<<<(B + 7) / 8, 256, 0, s>>>(
      (const unsigned*)part, (const unsigned*)ctab, (const long long*)stored,
      (long long*)crc, (int*)first_bad, B, nchunks, c0);
  return (int)cudaGetLastError();
}
