"""Behavioral emulation of robin_hood::unordered_flat_set<uint32_t>
(the reference's vendored hash set, robin_hood.hpp) — just enough to
reproduce its ITERATION ORDER: insert, erase, and begin().

Why this exists: the reference's fast pin solver "picks any uncovered
component" via `*universe.begin()` (pins.hpp:310-346). That "any" is
the first occupied bucket of a robin-hood open-addressing table, so
the selected pins — and therefore the condensed-pins stream bytes —
depend on the table's exact probing, resize, and backward-shift
deletion dynamics. Byte-exact encoding requires replaying them.

This is a from-scratch reimplementation of the documented semantics
(murmur-style hash_int finalizer, 5 info bits, 0.8 max load factor,
info-increment halving, backward-shift deletion), not a translation
of the robin_hood source; it holds only keys + info bytes in numpy
arrays. Verified against the compiled reference via the golden pin
fixtures (tests/test_golden.py).
"""
import numpy as np

_M64 = (1 << 64) - 1
_MULT0 = 0xC4CEB9FE1A85EC53
_MULT_STEP = 0xC4CEB9FE1A85EC54
_HASH_K = 0xFF51AFD7ED558CCD


def _hash_int(x: int) -> int:
  """robin_hood::hash_int — murmurhash3 finalizer minus the last
  mul/shift (performed by keyToIdx)."""
  x ^= x >> 33
  x = (x * _HASH_K) & _M64
  x ^= x >> 33
  return x


class RHFlatSetU32:
  """insert/erase/first with robin_hood bucket-order fidelity."""

  __slots__ = ('mult', 'mask', 'info', 'keys', 'n', 'max_allowed',
               'info_inc', 'info_shift')

  def __init__(self):
    self.mult = _MULT0
    self.mask = 0
    self.info = np.zeros(8, np.uint16)  # empty-state stand-in
    self.keys = np.zeros(0, np.uint32)
    self.n = 0
    self.max_allowed = 0
    self.info_inc = 32
    self.info_shift = 0

  # -- sizing -------------------------------------------------------
  @staticmethod
  def _max_allowed(buckets: int) -> int:
    return buckets * 80 // 100

  def _buffered(self, buckets: int) -> int:
    return buckets + min(self._max_allowed(buckets), 0xFF)

  def _init_data(self, buckets: int) -> None:
    self.n = 0
    self.mask = buckets - 1
    self.max_allowed = self._max_allowed(buckets)
    nb = self._buffered(buckets)
    # +1 sentinel; info is logically uint8 but kept u16 so probe
    # arithmetic that transiently exceeds 255 needs explicit casts
    # only where the reference casts
    self.info = np.zeros(nb + 1, np.uint16)
    self.info[nb] = 1  # sentinel
    self.keys = np.zeros(nb + 1, np.uint32)
    self.info_inc = 32
    self.info_shift = 0

  # -- hashing ------------------------------------------------------
  def _key_to_idx(self, key: int):
    h = (_hash_int(key) * self.mult) & _M64
    h ^= h >> 33
    info = self.info_inc + ((h & 31) >> self.info_shift)
    idx = (h >> 5) & self.mask
    return idx, info

  # -- core ops -----------------------------------------------------
  def add(self, key: int) -> None:
    info_arr = self.info
    for _attempt in range(256):
      idx, info = self._key_to_idx(key)
      while info < info_arr[idx]:
        idx += 1
        info += self.info_inc
      while info == info_arr[idx]:
        if self.keys[idx] == key:
          return  # already present
        idx += 1
        info += self.info_inc
      if self.n >= self.max_allowed:
        self._increase_size()
        info_arr = self.info
        continue
      ins_idx, ins_info = idx, info
      if ins_info + self.info_inc > 0xFF:
        self.max_allowed = 0
      while info_arr[idx] != 0:
        idx += 1
      if idx != ins_idx:
        self._shift_up(idx, ins_idx)
      info_arr[ins_idx] = ins_info & 0xFF
      self.keys[ins_idx] = key
      self.n += 1
      return
    raise OverflowError('robin_hood emulation: table overflow')

  def discard(self, key: int) -> None:
    if self.n == 0:
      return
    idx, info = self._key_to_idx(key)
    info_arr = self.info
    while True:
      if info == info_arr[idx] and self.keys[idx] == key:
        self._shift_down(idx)
        self.n -= 1
        return
      idx += 1
      info += self.info_inc
      if info > info_arr[idx]:
        return  # not present

  def first(self) -> int:
    """*begin(): the key in the lowest occupied bucket."""
    nz = np.flatnonzero(self.info)
    idx = int(nz[0])
    return int(self.keys[idx])

  def __len__(self) -> int:
    return self.n

  # -- shifting -----------------------------------------------------
  def _shift_up(self, start_idx: int, ins_idx: int) -> None:
    self.keys[ins_idx + 1:start_idx + 1] = self.keys[ins_idx:start_idx]
    idx = start_idx
    while idx != ins_idx:
      self.info[idx] = (self.info[idx - 1] + self.info_inc) & 0xFF
      if self.info[idx] + self.info_inc > 0xFF:
        self.max_allowed = 0
      idx -= 1

  def _shift_down(self, idx: int) -> None:
    info_arr = self.info
    while info_arr[idx + 1] >= 2 * self.info_inc:
      info_arr[idx] = (info_arr[idx + 1] - self.info_inc) & 0xFF
      self.keys[idx] = self.keys[idx + 1]
      idx += 1
    info_arr[idx] = 0

  # -- growth -------------------------------------------------------
  def _increase_size(self) -> None:
    if self.mask == 0:
      self._init_data(8)
      return
    max_allowed = self._max_allowed(self.mask + 1)
    if self.n < max_allowed and self._try_increase_info():
      return
    if self.n * 2 < max_allowed:
      # pathological probing: rehash same size with a new multiplier
      self.mult = (self.mult + _MULT_STEP) & _M64
      self._rehash(self.mask + 1)
    else:
      self._rehash((self.mask + 1) * 2)

  def _try_increase_info(self) -> bool:
    if self.info_inc <= 2:
      return False
    self.info_inc >>= 1
    self.info_shift += 1
    nb = self._buffered(self.mask + 1)
    self.info[:nb] >>= 1
    self.info[nb] = 1  # restore sentinel
    self.max_allowed = self._max_allowed(self.mask + 1)
    return True

  def _rehash(self, buckets: int) -> None:
    old_info = self.info
    old_keys = self.keys
    old_nb = self._buffered(self.mask + 1)
    self._init_data(buckets)
    for i in range(old_nb):
      if old_info[i] != 0:
        self._insert_move(int(old_keys[i]))

  def _insert_move(self, key: int) -> None:
    """Insert a key known to be absent (rehash path)."""
    if self.max_allowed == 0 and not self._try_increase_info():
      raise OverflowError('robin_hood emulation: table overflow')
    idx, info = self._key_to_idx(key)
    info_arr = self.info
    while info <= info_arr[idx]:
      idx += 1
      info += self.info_inc
    ins_idx = idx
    ins_info = info & 0xFF
    if ins_info + self.info_inc > 0xFF:
      self.max_allowed = 0
    while info_arr[idx] != 0:
      idx += 1
    if idx != ins_idx:
      self._shift_up(idx, ins_idx)
    info_arr[ins_idx] = ins_info
    self.keys[ins_idx] = key
    self.n += 1
