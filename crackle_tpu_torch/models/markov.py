"""Order-k finite-context (Markov) model over diff-coded crack
codepoints (reference parity: src/markov.hpp).

The alphabet is the 4 move directions. The context is the last k
diff-coded codepoints interpreted as a base-4 number (oldest digit at
4^0, newest at 4^(k-1)). Each of the 4^k model rows ranks the 4
directions by frequency; a row is one of 24 permutations and is stored
in 5 bits. The entropy coder emits rank 0 as '0' (1 bit), rank 1 as
'10', rank 2 as '110', rank 3 as '111' (bits listed in stream order,
LSB-first within bytes); the first codepoint of a slice is stored raw
in 2 bits.

Context gathering and rank extraction are vectorized; only the
rank->direction mapping during decode is inherently serial (the
context depends on previously decoded directions), so slices are the
parallel axis.
"""
from itertools import permutations
from typing import Dict, List, Tuple

import numpy as np

# 24 permutations of the 4 directions; a row is stored as an index
# into this table (markov.hpp:43-95 uses the same enumeration order:
# itertools.permutations order on [0,1,2,3]).
_PERMS = list(permutations(range(4)))
LUT = np.array(
  [sum(p[i] << (2 * i) for i in range(4)) for p in _PERMS],
  dtype=np.uint8,
)
ILUT = np.full(256, 255, dtype=np.uint8)
for _i, _el in enumerate(LUT):
  ILUT[_el] = _i


def contexts(code: np.ndarray, order: int) -> np.ndarray:
  """Context index before each position of a diff-coded stream.

  ctx[i] = sum_{j=1..k} code[i-j] * 4^(k-j), zeros before start.
  (CircularBuf parity: oldest digit at 4^0, newest at 4^(k-1).)
  """
  n = len(code)
  ctx = np.zeros(n, dtype=np.int64)
  for j in range(1, order + 1):
    weight = 4 ** (order - j)
    ctx[j:] += code[:-j].astype(np.int64) * weight
  return ctx


def gather_statistics(slice_codes: List[np.ndarray], order: int
                      ) -> np.ndarray:
  """4^k x 4 frequency counts over all slices' diff-coded codepoint
  streams (gather_statistics parity: the context buffer resets per
  slice and the first codepoint is counted against context 0)."""
  n_rows = 4 ** order
  stats = np.zeros(n_rows * 4, dtype=np.int64)
  for code in slice_codes:
    if len(code) == 0:
      continue
    ctx = contexts(code, order)
    stats += np.bincount(ctx * 4 + code, minlength=n_rows * 4)
  return stats.reshape(n_rows, 4)


def stats_to_model(stats: np.ndarray) -> np.ndarray:
  """Rank directions per row, most frequent first; ties broken by
  direction index DESCENDING. model[row][direction] = rank.

  Byte-exact with the reference (markov.hpp:222-266): its comparator
  is `a.second >= b.second` under std::sort, which for 4 elements is
  libstdc++'s insertion sort — equal counts keep floating an element
  past its equal predecessors, so among ties the HIGHER direction
  index lands at the lower rank. Sorting by the composite key
  count*4 + direction descending reproduces that order exactly
  (verified against the compiled reference in tests/test_golden.py)."""
  key = stats.astype(np.int64) * 4 + np.arange(4, dtype=np.int64)[None, :]
  order = np.argsort(-key, axis=1)  # rank -> direction, keys unique
  model = np.empty_like(order)
  rows = np.arange(stats.shape[0])[:, None]
  model[rows, order] = np.arange(4)[None, :]
  return model.astype(np.uint8)


def to_stored_model(model: np.ndarray) -> bytes:
  """Pack each row as a 5-bit permutation index, LSB-first
  (to_stored_model parity)."""
  n = model.shape[0]
  # invert: direction of each rank
  inv = np.empty_like(model)
  rows = np.arange(n)[:, None]
  inv[rows, model] = np.arange(4)[None, :]
  keys = (inv[:, 0] | (inv[:, 1] << 2) | (inv[:, 2] << 4)
          | (inv[:, 3] << 6)).astype(np.uint8)
  idxs = ILUT[keys]
  if (idxs == 255).any():
    raise ValueError("Corrupted model.")
  bits = ((idxs[:, None] >> np.arange(5)[None, :]) & 1).astype(np.uint8)
  packed = np.packbits(bits.ravel(), bitorder='little')
  return packed.tobytes()[: (5 * n + 4) // 8]


def from_stored_model(stored: bytes, order: int) -> np.ndarray:
  """Inverse of to_stored_model; returns model[row][direction] = rank."""
  n = 4 ** order
  bits = np.unpackbits(np.frombuffer(stored, dtype=np.uint8),
                       bitorder='little')
  need = 5 * n
  if len(bits) < need:
    bits = np.concatenate([bits, np.zeros(need - len(bits), np.uint8)])
  fields = bits[:need].reshape(n, 5)
  idxs = (fields * (1 << np.arange(5))[None, :]).sum(axis=1)
  rowvals = LUT[idxs % 24]  # guard corrupt indices
  # stored rows are rank -> direction; invert back to our
  # direction -> rank (encode) orientation
  inv = np.stack([
    rowvals & 0b11, (rowvals >> 2) & 0b11,
    (rowvals >> 4) & 0b11, (rowvals >> 6) & 0b11,
  ], axis=1).astype(np.uint8)
  model = np.empty_like(inv)
  rows = np.arange(n)[:, None]
  model[rows, inv.astype(np.int64)] = np.arange(4, dtype=np.uint8)[None, :]
  return model


# rank -> (bit pattern LSB-first, bit length)
_RANK_PATTERN = np.array([0b0, 0b01, 0b011, 0b111], dtype=np.uint8)
_RANK_LEN = np.array([1, 2, 3, 3], dtype=np.int64)


def encode_markov(code: np.ndarray, model: np.ndarray, order: int) -> bytes:
  """Entropy-code one slice's diff-coded codepoint stream
  (encode_markov parity). Fully vectorized: the contexts are derived
  from the (known) codepoints themselves."""
  if len(code) == 0:
    return b''
  from .. import native
  res = native.markov_encode(np.asarray(code, np.uint8), model, order)
  if res is not None:
    return res
  ctx = contexts(code, order)
  ranks = model[ctx[1:], code[1:]] if len(code) > 1 else \
      np.zeros(0, dtype=np.uint8)
  lens = _RANK_LEN[ranks]
  pats = _RANK_PATTERN[ranks]
  offsets = 2 + np.concatenate([[0], np.cumsum(lens[:-1])]) \
      if len(ranks) else np.zeros(0, dtype=np.int64)
  total_bits = 2 + int(lens.sum())
  bits = np.zeros(total_bits, dtype=np.uint8)
  bits[0] = code[0] & 1
  bits[1] = (code[0] >> 1) & 1
  if len(ranks):
    bits[offsets] = pats & 1
    m2 = lens >= 2
    bits[offsets[m2] + 1] = (pats[m2] >> 1) & 1
    m3 = lens >= 3
    bits[offsets[m3] + 2] = (pats[m3] >> 2) & 1
  return np.packbits(bits, bitorder='little').tobytes()


def decode_markov(stream: bytes, model: np.ndarray, order: int,
                  max_symbols: int = None) -> np.ndarray:
  """Decode one slice's bitstream back to (diff-decoded) codepoints
  (decode_codepoints parity, including the cumulative un-diff at the
  end).

  Symbol boundaries depend only on the bits (the code is
  length-prefixed by its leading 1-bits), so boundary and rank
  extraction are vectorized; only the rank->direction mapping walks
  serially because the context is the decoded history.
  """
  if len(stream) == 0:
    return np.zeros(0, dtype=np.uint8)
  from .. import native
  if native.available() and max_symbols is None:
    inv = np.empty_like(model)
    rows = np.arange(model.shape[0])[:, None]
    inv[rows, model.astype(np.int64)] = \
      np.arange(4, dtype=np.uint8)[None, :]
    res = native.markov_decode(bytes(stream), inv, order,
                               out_cap=8 * len(stream) + 2)
    if res is not None:
      return res
  bits = np.unpackbits(np.frombuffer(stream, dtype=np.uint8),
                       bitorder='little')
  nbits = len(bits)
  # decode lengths/ranks at every bit position, then chase boundaries
  b0 = bits
  b1 = np.concatenate([bits[1:], [0]])
  b2 = np.concatenate([bits[2:], [0, 0]])
  lens = np.where(b0 == 0, 1, np.where(b1 == 0, 2, 3))
  ranks = np.where(b0 == 0, 0, np.where(b1 == 0, 1, np.where(b2 == 0, 2, 3)))

  # the reference decodes until the byte stream is exhausted; trailing
  # garbage symbols are ignored downstream
  positions = []
  p = 2
  lens_l = lens.tolist()
  while p < nbits:
    positions.append(p)
    p += lens_l[p]
  if max_symbols is not None:
    positions = positions[:max_symbols]

  first = int(bits[0]) | (int(bits[1]) << 1)
  n_out = len(positions) + 1
  out = np.empty(n_out, dtype=np.uint8)
  out[0] = first

  # serial context walk (slices are the parallel axis)
  symranks = ranks[positions] if positions else np.zeros(0, np.int64)
  k = order
  ctx = first * (4 ** (k - 1)) if k >= 1 else 0
  # context as base-4 digits: oldest at 4^0; we keep the integer and
  # update incrementally like CircularBuf::push_back_and_update
  window = np.zeros(k, dtype=np.int64)
  widx = 0
  window[widx] = first
  widx = (widx + 1) % k if k else 0
  base10 = 0
  # recompute initial base10: oldest at 4^0 ... newest at 4^(k-1)
  for i in range(k):
    base10 += int(window[(widx + i) % k]) * (4 ** i)
  model_py = model  # [ctx][rank] -> direction? model is [row][dir]=rank
  # invert once: dirs_of_rank[row][rank] = direction
  inv = np.empty_like(model)
  rows = np.arange(model.shape[0])[:, None]
  inv[rows, model] = np.arange(4)[None, :]
  inv_l = inv.tolist()

  window_l = window.tolist()
  for j, r in enumerate(symranks.tolist()):
    d = inv_l[base10][r]
    out[j + 1] = d
    if k:
      front = window_l[widx]
      base10 -= front
      base10 >>= 2
      base10 += d * (1 << (2 * (k - 1)))
      window_l[widx] = d
      widx = (widx + 1) % k

  # un-diff: cumulative sum mod 4
  return (np.cumsum(out.astype(np.int64)) & 0b11).astype(np.uint8)


def compress_slice(chains: Dict[int, List[int]], model: np.ndarray,
                   order: int, sx: int, sy: int) -> bytes:
  """BOC index ++ markov bitstream for one slice (markov::compress
  parity)."""
  from ..ops.crackcode import (
    concat_chain_codepoints, difference_code, write_boc_index,
  )
  nodes, cps = concat_chain_codepoints(chains)
  binary = write_boc_index(nodes, sx, sy)
  diffs = difference_code(cps)
  return binary + encode_markov(diffs, model, order)
