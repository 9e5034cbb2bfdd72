"""CRC32C of each row of a (B, W) word tensor.

On a CUDA tensor, kernel 11 (csrc/crc32c.cu), which replaces
crackle_tpu/kernels/crc32c_tpu.py's XLA path (crc32c_words_traced,
crc32c_device; the TPU had no Pallas kernel for it): each row is read
once, cut into chunks of G groups of GROUP words aligned to its end,
each chunk's register is folded by a warp with byte tables in shared
memory, and a second pass combines the chunks. The tables are built
here in numpy and uploaded once a device and chunk length. With R0(m)
the register after folding message m into a zero register and A the
advance-by-one-zero-byte matrix,

    crc(m) = R0(m) XOR A^len(m)(0xFFFFFFFF) XOR 0xFFFFFFFF,
    R0(m1 ++ m2) = A^len(m2)(R0(m1)) XOR R0(m2).

On a CPU tensor, the plain version (crc32c_rows_plain) computes R0 of
each W_BLK-word block as a parity of bit-plane products with a fixed
(32, W_BLK, 32) table and folds the blocks in log depth, as
crc32c_tpu.py does. Each per-plane product sums at most W_BLK = 512
ones, which float32 holds exactly (TF32 is switched off for the
products all the same). Bit work is int64: PyTorch has little uint32
arithmetic.
"""
import functools

import numpy as np
import torch

from ..utils.profiling import count
from . import _build

_POLY = 0x82F63B78  # reflected Castagnoli

# the plain version's block of words
W_BLK = 512

# the kernel's chunks (csrc/crc32c.cu): a warp's LANES lanes read RUN
# consecutive words each, a group of GROUP words a step
LANES = 32
RUN = 4
GROUP = LANES * RUN
# warps of work wanted a SM: some three waves of the 48 that fit (three
# blocks of 16), so that the blocks balance over the card; at B = 512
# slices of 512^2 it gives 32-group chunks, the fastest of a sweep of
# powers of two (PERF.md)
CRC_FILL = 128
# chunks of a slice at most: the second pass folds 32 a step
MAX_CHUNKS = 2048


@functools.lru_cache(maxsize=1)
def _byte_table() -> np.ndarray:
  T = np.zeros(256, dtype=np.uint64)
  for i in range(256):
    crc = i
    for _ in range(8):
      crc = (crc >> 1) ^ _POLY if (crc & 1) else (crc >> 1)
    T[i] = crc
  return T.astype(np.uint32)


def _matmul_gf2(Ma, Mb):
  """Columns of Ma @ Mb over GF(2); each M is 32 u32 columns."""
  Ma = np.asarray(Ma, np.uint32)
  bits = (np.asarray(Mb, np.uint32)[:, None]
          >> np.arange(32, dtype=np.uint32)[None, :]) & np.uint32(1)
  return np.bitwise_xor.reduce(
    np.where(bits.astype(bool), Ma[None, :], np.uint32(0)), axis=1)


@functools.lru_cache(maxsize=64)
def _advance_cols(n_bytes: int) -> tuple:
  """Columns (as u32) of A^n_bytes, A(r) = (r >> 8) ^ T[r & 0xff]."""
  T = _byte_table()
  M = np.array([(1 << b >> 8) ^ int(T[(1 << b) & 0xFF]) for b in range(32)],
               np.uint32)
  R = np.array([1 << b for b in range(32)], np.uint32)
  n = n_bytes
  while n:
    if n & 1:
      R = _matmul_gf2(M, R)
    M = _matmul_gf2(M, M)
    n >>= 1
  return tuple(int(x) for x in R)


def _apply_cols(cols, vals: np.ndarray) -> np.ndarray:
  acc = np.zeros_like(vals)
  for b in range(32):
    acc ^= np.where((vals >> np.uint32(b)) & np.uint32(1),
                    np.uint32(cols[b]), np.uint32(0))
  return acc


@functools.lru_cache(maxsize=1)
def _block_table() -> np.ndarray:
  """(32, W_BLK, 32) float32: [j, w, b] = bit b of the R0 contribution
  of bit j of little-endian block word w; built back to front by
  doubling."""
  T = _byte_table()
  last = np.zeros(32, dtype=np.uint32)
  for j in range(32):
    v = int(T[1 << (j % 8)])
    for _ in range(3 - j // 8):
      v = (v >> 8) ^ int(T[v & 0xFF])
    last[j] = v
  D = last[None, :]
  while D.shape[0] < W_BLK:
    m = D.shape[0]
    D = np.concatenate([_apply_cols(_advance_cols(4 * m), D), D], axis=0)
  D = D[-W_BLK:]
  bits = (D[:, :, None] >> np.arange(32, dtype=np.uint32)[None, None, :]
          ) & np.uint32(1)
  return np.ascontiguousarray(np.transpose(bits, (1, 0, 2))
                              .astype(np.float32))


def _advance_bits(n_bytes: int) -> np.ndarray:
  """(32, 32) float32 M, M[i, b] = bit b of column i of A^n_bytes."""
  cols = np.array(_advance_cols(n_bytes), np.uint32)
  return ((cols[:, None] >> np.arange(32, dtype=np.uint32)[None, :])
          & np.uint32(1)).astype(np.float32)


@functools.lru_cache(maxsize=1024)
def _c0(n_words: int) -> int:
  """crc of the all-zero n-word message."""
  c = _apply_cols(_advance_cols(4 * n_words),
                  np.array([0xFFFFFFFF], np.uint32))[0]
  return int(c ^ np.uint32(0xFFFFFFFF))


def byte_tables(n_bytes: int) -> np.ndarray:
  """(256, 4) uint32 [i, p] = A^n_bytes(i << 8p): A^n of a register is
  the XOR of its four bytes' entries. Those of A^4 are the slicing-by-4
  tables: folding a word w into a register r gives A^4(r ^ w)."""
  vals = (np.arange(256, dtype=np.uint32)[:, None]
          << (8 * np.arange(4, dtype=np.uint32))[None, :])
  return _apply_cols(_advance_cols(n_bytes), vals)


def lane_cols(step_bytes: int, exps) -> np.ndarray:
  """(32, len(exps)) uint32 [b, l] = column b of A^(step_bytes *
  exps[l]): lane l's own advance, one column a bit of its register."""
  step = np.array(_advance_cols(step_bytes), np.uint32)
  powers = [np.array([1 << b for b in range(32)], np.uint32)]
  for _ in range(max(exps)):
    powers.append(_matmul_gf2(step, powers[-1]))
  return np.stack([powers[e] for e in exps], axis=1)


def chunk_tables(run: int = RUN, lanes: int = LANES) -> np.ndarray:
  """The chunk pass's tables, flat uint32: the byte tables of A^4 (a
  word's fold) and of A^(4 run (lanes - 1)) (a lane's skip over the
  other lanes' words of a group), then each lane's advance over the
  words after its own in a group (lane_cols)."""
  return np.concatenate([
    byte_tables(4).ravel(), byte_tables(4 * run * (lanes - 1)).ravel(),
    lane_cols(4 * run, [lanes - 1 - l for l in range(lanes)]).ravel()])


def combine_tables(chunk_words: int, lanes: int = LANES) -> np.ndarray:
  """The combine pass's tables, flat uint32: the byte tables of a step
  over `lanes` chunks, then lane l's advance over l chunks."""
  return np.concatenate([
    byte_tables(4 * chunk_words * lanes).ravel(),
    lane_cols(4 * chunk_words, range(lanes)).ravel()])


def chunk_groups(B: int, W: int, sms: int) -> int:
  """Groups of a chunk of the kernel for B rows of W words on a card of
  `sms` SMs: the largest power of two that still cuts the rows into
  CRC_FILL warps' tasks a SM, at least 1, and at most MAX_CHUNKS chunks
  a row."""
  groups = max(1, -(-W // GROUP))
  want = max(1, -(-CRC_FILL * sms // max(B, 1)))
  G = 1 << max(0, (groups // want).bit_length() - 1)
  while -(-groups // G) > MAX_CHUNKS:
    G *= 2
  return G


@functools.lru_cache(maxsize=None)
def _tables_on(device: torch.device, chunk_words: int):
  """chunk_tables() then combine_tables(chunk_words) as an int32 tensor on
  `device`, copied there once a device and chunk length."""
  count("host_syncs")  # the copy from pageable memory waits
  t = np.concatenate([chunk_tables(), combine_tables(chunk_words)])
  return torch.from_numpy(t.view(np.int32)).to(device)


_CHUNK_TABLE_WORDS = 2 * 256 * 4 + 32 * LANES


def _launch(words, stored):
  """Kernel 11 on a contiguous (B, W) int32 CUDA tensor: (crc (B,)
  int64, first (1,) int32 or None without stored)."""
  B, W = words.shape
  dev = words.device
  crc = torch.empty((B,), dtype=torch.int64, device=dev)
  first = None
  if stored is not None:
    first = torch.empty((1,), dtype=torch.int32, device=dev)
  if not B:
    if first is not None:
      first.zero_()
    return crc, first
  G = chunk_groups(B, W, _build.sm_count(dev))
  nchunks = max(1, -(-W // (G * GROUP)))
  part = torch.empty((B * nchunks,), dtype=torch.int32, device=dev)
  index = dev.index if dev.index is not None else torch.cuda.current_device()
  tables = _tables_on(torch.device("cuda", index), G * GROUP)
  vec = W % 4 == 0 and words.data_ptr() % 16 == 0
  err = _build.library().crc32c_rows_launch(
    words.data_ptr(), tables.data_ptr(),
    tables.data_ptr() + 4 * _CHUNK_TABLE_WORDS, part.data_ptr(),
    stored.data_ptr() if stored is not None else None, crc.data_ptr(),
    first.data_ptr() if first is not None else None, B, W, nchunks, G,
    int(vec), _c0(W), torch.cuda.current_stream(dev).cuda_stream)
  _build.check("crc32c_rows", err)
  _build.LAUNCHES["crc32c_rows"] += 1
  return crc, first


def _check_words(name, words):
  if words.dim() != 2:
    raise ValueError(f"{name}: want (B, W), got {tuple(words.shape)}")
  if words.device.type == "cuda" and words.dtype != torch.int32:
    raise ValueError(f"{name}: want int32 words on the card, got "
                     f"{words.dtype}")


def crc32c_rows(words):
  """CRC32C of each row of `words` ((B, W) int32, the little-endian
  u32 message of 4*W bytes). Returns (B,) int64 in [0, 2^32): from
  kernel 11 for a CUDA tensor, from the plain version for a CPU one."""
  _check_words("crc32c_rows", words)
  if words.device.type != "cuda":
    return crc32c_rows_plain(words)
  return _launch(words.contiguous(), None)[0]


def crc32c_first_mismatch(words, stored):
  """The CRC gate's work: (crc, first), crc = crc32c_rows(words) and
  first a (1,) int32 tensor on words' device holding the least row b
  with crc[b] != stored[b], or B where every row matches. stored: (B,)
  int64 on words' device. On the card the comparison is made by the
  kernel's own launch; nothing waits."""
  _check_words("crc32c_first_mismatch", words)
  B = words.shape[0]
  if (stored.dtype != torch.int64 or tuple(stored.shape) != (B,)
      or stored.device != words.device):
    raise ValueError(f"crc32c_first_mismatch: want (B,) int64 stored words "
                     f"on {words.device}, got {tuple(stored.shape)} "
                     f"{stored.dtype} on {stored.device}")
  if words.device.type == "cuda":
    return _launch(words.contiguous(), stored.contiguous())
  crc = crc32c_rows_plain(words)
  rows = torch.arange(B, dtype=torch.int64)
  first = torch.where(crc != stored, rows, B)
  return crc, torch.cat([first, torch.tensor([B])]).min().reshape(1).to(
    torch.int32)


def _parity_product(bits, M):
  """(bits @ M) & 1 for 0/1 float32 operands, exact in float32."""
  return torch.matmul(bits, M).to(torch.int64) & 1


def crc32c_rows_plain(words):
  """crc32c_rows as plain tensor code, on any device."""
  B, W = words.shape
  dev = words.device
  w = words.to(torch.int64) & 0xFFFFFFFF
  npad = (-W) % W_BLK
  if npad:
    # leading zero words leave R0 unchanged; the true length enters
    # only through c0
    w = torch.cat([torch.zeros((B, npad), dtype=torch.int64, device=dev), w],
                  1)
  nblk = w.shape[1] // W_BLK
  blocks = w.reshape(B * nblk, W_BLK)
  K = torch.from_numpy(_block_table()).to(dev)
  prev_tf32 = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    R = torch.zeros((B * nblk, 32), dtype=torch.int64, device=dev)
    for j in range(32):
      R ^= _parity_product(((blocks >> j) & 1).to(torch.float32), K[j])
    R = R.reshape(B, nblk, 32)
    # log-depth fold: combine(left, right) = advance(left) XOR right
    level = 0
    while nblk > 1:
      if nblk % 2:
        R = torch.cat([torch.zeros((B, 1, 32), dtype=torch.int64,
                                   device=dev), R], 1)
        nblk += 1
      M = torch.from_numpy(_advance_bits(4 * W_BLK << level)).to(dev)
      left = R[:, 0::2].reshape(-1, 32).to(torch.float32)
      R = _parity_product(left, M).reshape(B, nblk // 2, 32) ^ R[:, 1::2]
      nblk //= 2
      level += 1
  finally:
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
  crc = torch.sum(R[:, 0] << torch.arange(32, device=dev)[None, :], 1)
  return crc ^ _c0(W)
