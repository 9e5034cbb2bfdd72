"""Pin extraction and set-cover solvers for the condensed-pins label
format (reference parity: src/pins.hpp).

A "pin" is a maximal vertical run of one label at a fixed (x, y); it
covers the 2D connected components it passes through. Encoding a label
map as pins is a set-cover problem over each label's components.

The column/run extraction is vectorized (one pass over the volume);
the greedy cover solvers run on the candidate pins, which are tiny
compared to the volume.
"""
from dataclasses import dataclass, field
from typing import Dict, List, Tuple
import heapq

import numpy as np

from ..lib import crc32c
from .ccl import connected_components
from .rh_set import RHFlatSetU32


@dataclass
class CandidatePin:
  x: int
  y: int
  z_s: int
  z_e: int  # inclusive
  ccids: np.ndarray  # global slice-wise cc ids covered

  @property
  def depth(self) -> int:
    return self.z_e - self.z_s

  def start_idx(self, sx: int, sy: int) -> int:
    return self.x + sx * (self.y + sy * self.z_s)


def extract_columns(labels: np.ndarray, cc_labels: np.ndarray,
                    sx: int, sy: int, sz: int
                    ) -> Dict[int, List[CandidatePin]]:
  """All maximal same-label vertical runs, grouped by label
  (extract_columns parity, pins.hpp:126-163; the previous-column
  superset dedup is an encoder-size heuristic and is applied here
  too).

  labels/cc_labels: flat x-fastest volumes.
  """
  sxy = sx * sy
  vol = labels.reshape(sz, sxy)       # [z][c] with c = x + sx*y
  ccv = cc_labels.reshape(sz, sxy)

  # column-major flatten: all z of column 0, then column 1, ...
  flat = np.ascontiguousarray(vol.T).ravel()
  ccf = np.ascontiguousarray(ccv.T).ravel()
  n = len(flat)
  if n == 0:
    return {}

  is_start = np.ones(n, dtype=bool)
  is_start[1:] = flat[1:] != flat[:-1]
  col_start = (np.arange(n) % sz) == 0
  is_start |= col_start
  starts = np.flatnonzero(is_start)
  ends = np.concatenate([starts[1:], [n]]) - 1  # inclusive

  run_label = flat[starts]
  run_col = starts // sz
  run_zs = starts % sz
  run_ze = ends % sz
  run_x = run_col % sx
  run_y = run_col // sx

  pinsets: Dict[int, List[CandidatePin]] = {}
  for i in range(len(starts)):
    label = int(run_label[i])
    pin = CandidatePin(
      x=int(run_x[i]), y=int(run_y[i]),
      z_s=int(run_zs[i]), z_e=int(run_ze[i]),
      ccids=ccf[starts[i]:ends[i] + 1],
    )
    lst = pinsets.setdefault(label, [])
    if lst:
      last = lst[-1]
      if last.x == pin.x - 1 and last.y == pin.y:
        if last.z_s <= pin.z_s and last.z_e >= pin.z_e:
          continue  # previous column's pin covers a superset interval
        elif last.z_s >= pin.z_s and last.z_e <= pin.z_e:
          lst[-1] = pin
          continue
    lst.append(pin)
  return pinsets


def find_suboptimal_pins(pins: List[CandidatePin],
                         universe) -> List[CandidatePin]:
  """Fast heuristic cover, byte-exact with the reference
  (find_suboptimal_pins, pins.hpp:300-346): repeatedly take an
  uncovered component and a deep pin covering it.

  Two reference behaviors are observable in the stream bytes and are
  reproduced faithfully:
  - "pick any uncovered cc" is `*universe.begin()` on a robin_hood
    flat set, i.e. the lowest occupied BUCKET, so the pick order
    replays that table's probing/deletion dynamics (rh_set.py);
  - the selection scan initializes max_depth from the first candidate
    and never updates it (pins.hpp:328-336), so it selects the LAST
    candidate deeper than the FIRST one — not the argmax.

  `universe`: the label's distinct global cc ids in ascending order
  (== first-appearance order of the reference's multiverse scan,
  pins.hpp:166-198, since global cc ids are assigned in the same
  raster order that scan walks).
  """
  final_pins: List[CandidatePin] = []
  if not pins:
    return final_pins

  component_to_pins: Dict[int, List[int]] = {}
  for i, pin in enumerate(pins):
    for ccid in pin.ccids:
      component_to_pins.setdefault(int(ccid), []).append(i)

  rh = RHFlatSetU32()
  for c in universe:
    rh.add(int(c))

  while len(rh):
    picked = rh.first()
    candidates = component_to_pins[picked]
    max_pin = pins[candidates[0]]
    d0 = max_pin.depth
    for i in candidates[1:]:
      if pins[i].depth > d0:
        max_pin = pins[i]
    for c in max_pin.ccids:
      rh.discard(int(c))
    final_pins.append(max_pin)
  return final_pins


def _shrink_pin_to_fit(pin: CandidatePin, remaining: set) -> CandidatePin:
  """Trim a chosen pin's z-range to the slices of its min/max still-
  uncovered components (shrink_pin_to_fit parity). Global cc ids
  increase with z, so min/max ids bound the needed range."""
  ids = [int(c) for c in pin.ccids if int(c) in remaining]
  if not ids:
    return pin
  min_id, max_id = min(ids), max(ids)
  full = [int(c) for c in pin.ccids]
  z_s = pin.z_s
  z_e = pin.z_e
  for off, cid in enumerate(full):
    if cid == min_id:
      z_s = pin.z_s + off
    if cid == max_id:
      z_e = pin.z_s + off
      break
  return CandidatePin(pin.x, pin.y, z_s, z_e,
                      np.asarray(ids, dtype=np.int64))


def find_optimal_pins(pins: List[CandidatePin],
                      universe: set) -> List[CandidatePin]:
  """Greedy max-coverage with a lazy-deletion heap (replaces the
  reference's pairing-heap decrease-key machinery,
  find_optimal_pins parity in outcome)."""
  final_pins: List[CandidatePin] = []
  if not pins:
    return final_pins

  uncovered = set(int(c) for c in universe)
  live = [set(int(c) for c in p.ccids) for p in pins]
  heap = [(-len(s), i) for i, s in enumerate(live)]
  heapq.heapify(heap)
  taken = [False] * len(pins)

  while uncovered and heap:
    negsize, i = heapq.heappop(heap)
    if taken[i]:
      continue
    cur = len(live[i] & uncovered)
    if cur == 0:
      taken[i] = True
      continue
    if -negsize != cur:
      heapq.heappush(heap, (-cur, i))
      continue
    taken[i] = True
    covered_now = live[i] & uncovered
    pin = _shrink_pin_to_fit(pins[i], covered_now)
    uncovered -= covered_now
    final_pins.append(pin)

  return final_pins


def compute(labels: np.ndarray, sx: int, sy: int, sz: int,
            optimize: bool = False):
  """Full pin computation (pins.hpp:348-403 parity).

  Returns (all_pins dict label -> [CandidatePin], num_components_per_
  slice, N_total, per-slice crack crcs over slice-local uint32 CCL).
  """
  sxy = sx * sy
  cc_labels, num_per_slice, n_total = connected_components(
    labels, sx, sy, sz
  )

  pinsets = extract_columns(labels, cc_labels, sx, sy, sz)

  # universe per label: all global cc ids belonging to the label.
  # The fast solver needs them in ascending order (== the reference's
  # multiverse insertion order); the optimal solver takes a plain set.
  all_pins: Dict[int, List[CandidatePin]] = {}
  for label, pins in pinsets.items():
    ccids = np.unique(np.concatenate([p.ccids for p in pins]))
    if optimize:
      all_pins[label] = find_optimal_pins(pins, set(int(c) for c in ccids))
    else:
      all_pins[label] = find_suboptimal_pins(pins, ccids)

  # per-slice crcs over slice-local (renumbered-from-0) cc labels
  crcs = np.zeros(sz, dtype=np.uint32)
  offset = 0
  ccv = cc_labels.reshape(sz, sxy)
  for z in range(sz):
    local = (ccv[z] - offset).astype('<u4')
    crcs[z] = crc32c(np.ascontiguousarray(local))
    offset += int(num_per_slice[z])

  return all_pins, num_per_slice, n_total, crcs
