"""Low-level byte plumbing for the .ckl container format.

The port's copy of crackle_tpu/lib.py: the host-side serialization
layer (reference parity: src/lib.hpp, src/crc.hpp, crackle/lib.py).
Everything here is little-endian byte twiddling that frames the
device-computed payloads.
"""
from typing import Union
import numpy as np

try:
  import google_crc32c as _g_crc32c
  _HAS_GOOGLE_CRC = True
except ImportError:  # pragma: no cover
  _HAS_GOOGLE_CRC = False

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli). The reference computes the standard CRC-32C
# (init 0xFFFFFFFF, reflected, final xor) via third_party/fastcrc
# (crc32_impl called with acc=0, which internally inverts on entry/exit).
# google_crc32c produces the identical value.
# ---------------------------------------------------------------------------

def _make_crc32c_table():
  poly = 0x82F63B78  # reflected Castagnoli polynomial
  table = np.zeros(256, dtype=np.uint64)
  for i in range(256):
    crc = i
    for _ in range(8):
      crc = (crc >> 1) ^ poly if (crc & 1) else (crc >> 1)
    table[i] = crc
  return table.astype(np.uint32)

_CRC32C_TABLE = _make_crc32c_table()

def _crc32c_py(data: bytes) -> int:
  crc = 0xFFFFFFFF
  tbl = _CRC32C_TABLE
  for b in data:
    crc = int(tbl[(crc ^ b) & 0xFF]) ^ (crc >> 8)
  return crc ^ 0xFFFFFFFF

def crc32c(buffer: Union[bytes, bytearray, memoryview, np.ndarray]) -> int:
  """Standard CRC-32C of the buffer (matches reference crc::crc32c)."""
  if isinstance(buffer, np.ndarray):
    buffer = np.ascontiguousarray(buffer)
    buffer = buffer.view(np.uint8).tobytes()
  elif isinstance(buffer, (bytearray, memoryview)):
    buffer = bytes(buffer)
  if _HAS_GOOGLE_CRC:
    return int.from_bytes(_g_crc32c.Checksum(buffer).digest(), 'big')
  # without google_crc32c, the native library's hardware CRC; the
  # per-byte Python loop is the last resort (a 512^2 slice's CCL image
  # takes it about a second)
  from . import native
  crc = native.crc32c(buffer)
  return _crc32c_py(buffer) if crc is None else crc

def crc8(data: Union[bytes, bytearray, memoryview]) -> int:
  """CRC8 with implicit polynomial 0xe7, init 0xFF (reference crc::crc8).

  Guards the 29-byte header (bytes 5..27). Detects all <=2 bit flips for
  messages up to 247 bits.
  """
  polynomial = 0xe7
  crc = 0xFF
  for b in bytes(data):
    crc ^= b
    for _ in range(8):
      crc = ((crc >> 1) ^ polynomial) if (crc & 1) else (crc >> 1)
  return crc & 0xFF

# ---------------------------------------------------------------------------
# Integer <-> bytes helpers (reference lib::itoc/ctoi/itocd/ctoid).
# ---------------------------------------------------------------------------

width2dtype = {
  1: np.uint8,
  2: np.uint16,
  4: np.uint32,
  8: np.uint64,
}

def compute_byte_width(x: int) -> int:
  """Smallest power-of-two byte width holding x (1, 2, 4, or 8)."""
  x = int(x)
  if x <= 0xFF:
    return 1
  elif x <= 0xFFFF:
    return 2
  elif x <= 0xFFFFFFFF:
    return 4
  return 8

def compute_dtype(x: int) -> np.dtype:
  return width2dtype[compute_byte_width(x)]

def itoc(x: int, width: int) -> bytes:
  """Little-endian encode x at the given byte width."""
  return int(x).to_bytes(width, 'little')

def ctoi(buf, idx: int, width: int) -> int:
  """Little-endian decode an integer at the given byte width."""
  return int.from_bytes(bytes(buf[idx:idx + width]), 'little')

# ---------------------------------------------------------------------------
# Bitfield pack/unpack for the header format word (crackle/lib.py parity).
# ---------------------------------------------------------------------------

def pack_bits(fields) -> int:
  """fields: sequence of (value, bit_count). LSB first."""
  out = 0
  shift = 0
  for value, bits in fields:
    out |= (int(value) & ((1 << bits) - 1)) << shift
    shift += bits
  return out

def unpack_bits(value: int, bit_counts) -> list:
  """Inverse of pack_bits; returns list of values, LSB first."""
  out = []
  shift = 0
  for bits in bit_counts:
    out.append((value >> shift) & ((1 << bits) - 1))
    shift += bits
  return out

# ---------------------------------------------------------------------------
# Misc small utilities used across the codec.
# ---------------------------------------------------------------------------

def fit_dtype(dtype, maxval: int, signed: bool = False):
  """Smallest dtype of the same kind that holds maxval (fastremap parity)."""
  dtype = np.dtype(dtype)
  if np.issubdtype(dtype, np.signedinteger) or signed:
    candidates = [np.int8, np.int16, np.int32, np.int64]
  else:
    candidates = [np.uint8, np.uint16, np.uint32, np.uint64]
  for c in candidates:
    if maxval <= np.iinfo(c).max:
      return np.dtype(c)
  raise ValueError(f"No dtype can hold {maxval}")

def eytzinger_order(arr: np.ndarray) -> np.ndarray:
  """Return arr laid out in eytzinger (BFS heap) order for cache-friendly
  binary search (reference crackle/lib.py:52-72). Input must be sorted."""
  n = len(arr)
  out = np.zeros_like(arr)
  def recur(i_sorted, k):
    if k <= n:
      i_sorted = recur(i_sorted, 2 * k)
      out[k - 1] = arr[i_sorted]
      i_sorted += 1
      i_sorted = recur(i_sorted, 2 * k + 1)
    return i_sorted
  recur(0, 1)
  return out
