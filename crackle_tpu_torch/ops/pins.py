"""Pin extraction and set-cover solvers for the condensed-pins label
format (reference parity: src/pins.hpp).

A "pin" is a maximal vertical run of one label at a fixed (x, y); it
covers the 2D connected components it passes through. Encoding a label
map as pins is a set-cover problem over each label's components.

The column scan (every vertical run and the reference's previous-column
dedup) and the component -> pins index of the fast solver are array
code in torch, on the device the labels lie on (a card's, or the CPU's
for the host encoder). The fast solver's pick order, the iteration
order of a robin-hood hash set, runs in the native library (rh_set.py
where it is missing) over each component's precomputed choice of pin;
the optimal solver runs on the host over candidate lists.
"""
from dataclasses import dataclass
from typing import Dict, List
import heapq

import numpy as np
import torch

from .. import native
from ..lib import crc32c
from ..utils.profiling import count, span
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


@dataclass
class Columns:
  """The candidate pins of a volume: every maximal same-label vertical
  run the previous-column dedup keeps, grouped by label, in column-major
  order (column c = x + sx * y, then z) within a label: col, z_s, z_e
  (K,) int64 tensors on the labels' device (z_e inclusive); labels, the
  L labels (unsigned ints) in order of their first run (the reference's
  dict order), and seg (L + 1,) int64 host offsets of each one's pins."""
  labels: List[int]
  col: torch.Tensor
  z_s: torch.Tensor
  z_e: torch.Tensor
  seg: np.ndarray

  @property
  def n(self) -> int:
    return self.col.numel()


def _unsigned(values) -> List[int]:
  """Label values of a signed view back to their unsigned ints."""
  bits = torch.iinfo(values.dtype).bits
  return [int(x) & ((1 << bits) - 1)
          for x in values.cpu().to(torch.int64).tolist()]


def _starts(first):
  """Sorted positions where `first` (bool (n,)) holds, and each one's
  inclusive end: the position before the next, or n - 1."""
  n = first.numel()
  count("host_syncs")  # nonzero's size
  start = torch.nonzero(first).squeeze(1)
  end = torch.cat([start[1:], start.new_tensor([n])]) - 1
  return start, end


def extract_columns(labels, sx: int, sz: int) -> Columns:
  """All maximal same-label vertical runs, grouped by label, with the
  reference's previous-column dedup applied (extract_columns parity,
  pins.hpp:95-163). labels: (sz, sx * sy) tensor, x fastest.

  The reference appends each run to its label's list unless the list's
  last pin lies in the column before (x - 1, same y) and its z range
  holds the run's (skipped), or the run's holds it (the run replaces
  it). Here: the runs sorted by (label, column, z); a column's runs of
  one label meet the state the column before left, the last run there
  unless all of that column's runs were skipped. Whether all of a
  column's runs are skipped alternates along a streak of columns whose
  runs all fit the run before them, so one running max gives it."""
  dev = labels.device
  flat = labels.t().contiguous().reshape(-1)  # column by column, z fastest
  n = flat.numel()
  first = torch.ones(n, dtype=torch.bool, device=dev)
  first[1:] = flat[1:] != flat[:-1]
  first[::sz] = True
  start, end = _starts(first)
  del first
  lab = flat[start]
  del flat
  # group by label; the stable sort keeps each label's runs in (col, z)
  # order, the order of its list
  lab, order = torch.sort(lab, stable=True)
  start, end = start[order], end[order]
  col, zs, ze = start // sz, start % sz, end % sz
  R = col.numel()
  brk = torch.ones(R, dtype=torch.bool, device=dev)
  brk[1:] = (lab[1:] != lab[:-1]) | (col[1:] != col[:-1])
  g0, g1 = _starts(brk)  # each (label, column) group's first and last run
  gid = torch.cumsum(brk, 0) - 1
  del brk
  G = g0.numel()
  # adj: the group before is the same label's, one column to the left
  adj = torch.zeros(G, dtype=torch.bool, device=dev)
  adj[1:] = ((lab[g0[1:]] == lab[g0[:-1]]) & (col[g0[1:]] == col[g0[:-1]] + 1)
             & (col[g0[1:]] % sx != 0))
  # the state a run meets: the last run of the column before
  ref = torch.clamp(g0[gid] - 1, min=0)
  inside = adj[gid] & (zs[ref] <= zs) & (ze[ref] >= ze)
  out = (~inside).to(torch.int64)
  run_out = torch.cumsum(out, 0)
  # prefix: every run of the group up to this one lies inside the state
  prefix = (run_out - (run_out[g0] - out[g0])[gid]) == 0
  del run_out, out, inside
  fits = prefix[g1]  # all of the group's runs lie inside (implies adj)
  idx = torch.arange(G, device=dev)
  streak = torch.cummax(torch.where(fits, -1, idx), 0).values
  all_skipped = fits & ((idx - streak) % 2 == 1)
  live = torch.zeros(G, dtype=torch.bool, device=dev)  # state still there
  live[1:] = adj[1:] & ~all_skipped[:-1]
  skip = live[gid] & prefix
  # a group's first run that holds the state (and is not equal to it)
  # replaces it in the list
  f = g0[1:]
  repl = live[1:] & ~skip[f] & (zs[f] <= zs[f - 1]) & (ze[f] >= ze[f - 1])
  keep = ~skip
  keep[(f - 1)[repl]] = False
  count("host_syncs")  # nonzero's size
  kept = torch.nonzero(keep).squeeze(1)
  # each label's first run in the volume orders the labels: a stable
  # sort of the kept runs by it keeps each label's own order
  lab_first = torch.ones(R, dtype=torch.bool, device=dev)
  lab_first[1:] = lab[1:] != lab[:-1]
  key = order[lab_first][torch.cumsum(lab_first, 0)[kept] - 1]
  key, o2 = torch.sort(key, stable=True)
  kept = kept[o2]
  count("host_syncs")
  per = torch.unique_consecutive(key, return_counts=True)[1].cpu().numpy()
  seg = np.concatenate([[0], np.cumsum(per)]).astype(np.int64)
  labels = _unsigned(lab[kept[torch.from_numpy(seg[:-1]).to(dev)]])
  return Columns(labels, col[kept], zs[kept], ze[kept], seg)


def _pairs(cols: Columns, cc, sxy: int):
  """Every (pin, component) pair: pin (P,) int64 indices into cols and
  comp (P,) int64 the component each pin crosses, pin by pin and z by z.
  cc: (sz, sxy) global component ids."""
  ln = cols.z_e - cols.z_s + 1
  count("host_syncs")
  P = int(ln.sum())
  dev = ln.device
  pin = torch.repeat_interleave(torch.arange(cols.n, device=dev), ln,
                                output_size=P)
  k = torch.arange(P, device=dev) - (torch.cumsum(ln, 0) - ln)[pin]
  comp = cc.reshape(-1)[(cols.z_s[pin] + k) * sxy + cols.col[pin]]
  return pin, comp.to(torch.int64)


def cover_choice(cols: Columns, pin, comp, n_total: int):
  """Each component's pin under the fast solver (find_suboptimal_pins,
  pins.hpp:300-346): of the pins crossing it in list order, the last
  one deeper than the first, else the first (the reference's scan
  initializes max_depth from the first candidate and never updates it,
  pins.hpp:328-336). Returns (n_total,) int64 indices into cols, n for
  a component no pin crosses."""
  depth = cols.z_e - cols.z_s
  K = cols.n
  first = torch.full((n_total,), K, dtype=torch.int64, device=pin.device)
  first.scatter_reduce_(0, comp, pin, "amin")
  d0 = torch.cat([depth, depth.new_tensor([-1])])[first]
  deeper = depth[pin] > d0[comp]
  last = torch.full((n_total,), -1, dtype=torch.int64, device=pin.device)
  last.scatter_reduce_(0, comp[deeper], pin[deeper], "amax")
  return torch.where(last >= 0, last, first)


def pick(uni, uoff, choice, coff, cids):
  """The fast solver's picks, label by label: each label's components
  (uni[uoff[j]:uoff[j + 1]], ascending) go into a robin-hood set; while
  it is not empty, its first bucket's component names a pin
  (choice[component], an index into the CSR lists coff/cids of the
  components each pin crosses), whose components leave the set. Returns
  (picks int32, per-label counts int64) as numpy."""
  got = native.pins_pick(uni, uoff, choice, coff, cids)
  if got is not None:
    return got
  picks, counts = [], np.zeros(len(uoff) - 1, np.int64)
  for j in range(len(uoff) - 1):
    rh = RHFlatSetU32()
    for c in uni[uoff[j]:uoff[j + 1]].tolist():
      rh.add(c)
    while len(rh):
      k = int(choice[rh.first()])
      for c in cids[coff[k]:coff[k + 1]].tolist():
        rh.discard(c)
      picks.append(k)
      counts[j] += 1
  return np.asarray(picks, np.int32), counts


def _fast_pins(cols: Columns, cc, sx: int, sxy: int, n_total: int):
  """The fast solver over every label: {label: [CandidatePin]}."""
  dev = cols.col.device
  pin, comp = _pairs(cols, cc, sxy)
  choice = cover_choice(cols, pin, comp, n_total)
  K = cols.n
  # each label's components, ascending: a stable sort by the label of
  # the first pin crossing each
  pin_seg = torch.repeat_interleave(
    torch.arange(len(cols.seg) - 1, device=dev),
    torch.from_numpy(np.diff(cols.seg)).to(dev), output_size=K)
  comps = torch.arange(n_total, device=dev)
  crossed = choice < K
  seg_of = pin_seg[choice[crossed]]
  seg_of, o = torch.sort(seg_of, stable=True)
  uni = comps[crossed][o]
  # the pins some component names, and the components each crosses
  cand = torch.zeros(K + 1, dtype=torch.bool, device=dev)
  cand[choice] = True
  cand = cand[:K]
  cidx = torch.cumsum(cand, 0) - 1
  on = cand[pin]
  cids = comp[on]
  ln = (cols.z_e - cols.z_s + 1)[cand]
  count("host_syncs", 5)  # the five tables to the host
  h_uoff = np.concatenate(
    [[0], np.cumsum(torch.bincount(seg_of, minlength=len(cols.seg) - 1)
                    .cpu().numpy())]).astype(np.int64)
  h_choice = torch.where(crossed, cidx[torch.clamp(choice, max=K - 1)],
                         -1).to(torch.int32).cpu().numpy()
  h_cids = cids.to(torch.int64).cpu().numpy().astype(np.uint32)
  h_coff = np.concatenate([[0], np.cumsum(ln.cpu().numpy())]).astype(
    np.int64)
  picks, per = pick(uni.cpu().numpy().astype(np.uint32), h_uoff, h_choice,
                    h_coff, h_cids)
  count("host_syncs", 2)  # nonzero's size, the picked pins to the host
  which = torch.nonzero(cand).squeeze(1)
  sel = which[torch.from_numpy(picks.astype(np.int64)).to(dev)]
  col, zs, ze = torch.stack(
    [cols.col[sel], cols.z_s[sel], cols.z_e[sel]]).cpu().numpy()
  out: Dict[int, List[CandidatePin]] = {}
  i = 0
  for label, m in zip(cols.labels, per.tolist()):
    out[label] = [
      CandidatePin(int(col[j] % sx), int(col[j] // sx), int(zs[j]),
                   int(ze[j]), h_cids[h_coff[k]:h_coff[k + 1]])
      for j, k in zip(range(i, i + m), picks[i:i + m].tolist())]
    i += m
  return out


def _optimal_pins(cols: Columns, cc, sx: int, sxy: int):
  """The optimal solver over every label's candidate pins."""
  pin, comp = _pairs(cols, cc, sxy)
  ln = (cols.z_e - cols.z_s + 1).cpu().numpy()
  off = np.concatenate([[0], np.cumsum(ln)])
  comp = comp.cpu().numpy()
  col = cols.col.cpu().numpy()
  zs, ze = cols.z_s.cpu().numpy(), cols.z_e.cpu().numpy()
  out: Dict[int, List[CandidatePin]] = {}
  for j, label in enumerate(cols.labels):
    pins = [CandidatePin(int(col[i] % sx), int(col[i] // sx), int(zs[i]),
                         int(ze[i]), comp[off[i]:off[i + 1]])
            for i in range(cols.seg[j], cols.seg[j + 1])]
    universe = set(np.unique(comp[off[cols.seg[j]]:off[cols.seg[j + 1]]])
                   .tolist())
    out[label] = find_optimal_pins(pins, universe)
  return out


def solve(labels, cc, sx: int, sy: int, sz: int, n_total: int,
          optimize: bool = False) -> Dict[int, List[CandidatePin]]:
  """The pins of a volume: {label: [CandidatePin]}, labels in order of
  their first vertical run. labels: (sz, sx * sy) tensor, x fastest, on
  any device (unsigned labels in their signed view); cc: (sz, sx * sy)
  global slice-wise component ids on the same device; n_total: the
  number of components. optimize picks the greedy-optimal solver."""
  sxy = sx * sy
  dev = labels.device
  with span("encode.pins", dev):
    with span("encode.pins_columns", dev):
      cols = extract_columns(labels, sx, sz)
    with span("encode.pins_cover", dev):
      if optimize:
        out = _optimal_pins(cols, cc, sx, sxy)
      else:
        out = _fast_pins(cols, cc, sx, sxy, n_total)
    count("pins_candidates", cols.n)
    count("pins_chosen", sum(len(v) for v in out.values()))
  return out


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


_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
           np.dtype(np.uint64): np.int64}


def compute(labels: np.ndarray, sx: int, sy: int, sz: int,
            optimize: bool = False):
  """Full pin computation on the host (pins.hpp:348-403 parity).
  labels: flat x-fastest volume.

  Returns (all_pins dict label -> [CandidatePin], num_components_per_
  slice, N_total, per-slice crack crcs over slice-local uint32 CCL).
  """
  sxy = sx * sy
  cc_labels, num_per_slice, n_total = connected_components(
    labels, sx, sy, sz
  )
  lab = np.ascontiguousarray(labels)
  lab = lab.view(_SIGNED.get(lab.dtype, lab.dtype))
  all_pins = solve(
    torch.from_numpy(lab).reshape(sz, sxy),
    torch.from_numpy(cc_labels.astype(np.int64)).reshape(sz, sxy),
    sx, sy, sz, int(n_total), optimize)

  # per-slice crcs over slice-local (renumbered-from-0) cc labels
  crcs = np.zeros(sz, dtype=np.uint32)
  offset = 0
  ccv = cc_labels.reshape(sz, sxy)
  for z in range(sz):
    local = (ccv[z] - offset).astype('<u4')
    crcs[z] = crc32c(np.ascontiguousarray(local))
    offset += int(num_per_slice[z])

  return all_pins, num_per_slice, n_total, crcs
