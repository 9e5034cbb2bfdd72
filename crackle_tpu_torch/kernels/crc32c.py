"""CRC32C of each row of a (B, W) word tensor, as GF(2) linear algebra.

Counterpart of crackle_tpu/kernels/crc32c_tpu.py (crc32c_words_traced,
crc32c_device), which is XLA rather than Pallas: the same block
table and log-depth fold, as plain tensor code that runs on whatever
device holds the words. With R0(m) the register after folding message
m into a zero register and A the advance-by-one-zero-byte matrix,

    crc(m) = R0(m) XOR A^len(m)(0xFFFFFFFF) XOR 0xFFFFFFFF,

and R0 of each W_BLK-word block is a parity of bit-plane products
with a fixed (32, W_BLK, 32) table. Each per-plane product sums at most
W_BLK = 512 ones, which float32 holds exactly (TF32 is switched off
for the products all the same). Bit work is int64: PyTorch has little
uint32 arithmetic on CUDA.
"""
import functools

import numpy as np
import torch

from ..utils.profiling import count

_POLY = 0x82F63B78  # reflected Castagnoli

W_BLK = 512


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
  out = np.zeros(32, dtype=np.uint32)
  for b in range(32):
    v = int(Mb[b])
    acc = 0
    for k in range(32):
      if (v >> k) & 1:
        acc ^= int(Ma[k])
    out[b] = acc
  return out


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


def _parity_product(bits, M):
  """(bits @ M) & 1 for 0/1 float32 operands, exact in float32."""
  return torch.matmul(bits, M).to(torch.int64) & 1


def crc32c_rows(words):
  """CRC32C of each row of `words` ((B, W) int32, the little-endian
  u32 message of 4*W bytes). Returns (B,) int64 in [0, 2^32)."""
  if words.dim() != 2:
    raise ValueError(f"crc32c_rows: want (B, W), got {tuple(words.shape)}")
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
  count("host_syncs")  # each table's copy from pageable memory waits
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
      count("host_syncs")
      M = torch.from_numpy(_advance_bits(4 * W_BLK << level)).to(dev)
      left = R[:, 0::2].reshape(-1, 32).to(torch.float32)
      R = _parity_product(left, M).reshape(B, nblk // 2, 32) ^ R[:, 1::2]
      nblk //= 2
      level += 1
  finally:
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
  crc = torch.sum(R[:, 0] << torch.arange(32, device=dev)[None, :], 1)
  return crc ^ _c0(W)
