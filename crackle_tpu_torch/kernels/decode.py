"""Batched slice decode on a torch device.

Counterpart of crackle_tpu/kernels/decode.py: packed crack streams ->
VCG (replay kernels) -> first-visit CCL and label paint (CCL kernels,
or the gather paint past PAINT_CAP_N components a slice), and the split
decode of slices longer than the device capacity. Inputs are the
tensors of engine.prepare_slice_inputs (or prepare_split_inputs, one
row a piece) on one device:

  packed:   (B, CAP_B) uint8  packed move bytes (BOC stripped)
  nbytes:   (B,)       int32  valid byte count per slice
  nodes:    (B, CAP_CH) int32 chain start corner nodes
  n_chains: (B,)       int32  valid chain count per slice
"""
import torch

from ..utils.profiling import count, span
from . import ccl as _ccl
from . import replay as _replay


def _edge_ids(packed, nbytes, nodes, n_chains, sx: int, sy: int):
  """Edge ids (B, CAP) int32 through replay_keys and replay_positions,
  or with replay.CANCEL_COMPACT through the compact-cancel kernels in
  place of replay_positions (the same edge ids). Neither path sorts."""
  ev, cls, drange = _replay.replay_keys(packed, nbytes, n_chains)
  if _replay.CANCEL_COMPACT:
    dense = _replay.cancel_sums(ev, cls, drange)
    tables = _replay.compact_closes(
      dense, _replay.close_cap(ev.shape[1], nodes.shape[1]))
    return _replay.replay_positions_compact(cls, tables, nodes, sx, sy)
  return _replay.replay_positions(ev, cls, drange, nodes, sx, sy)


def _vcg_for_ccl(packed, nbytes, nodes, n_chains, sx: int, sy: int,
                 permissible: bool):
  """VCG (B, sy, sx) int32, crack-format complement applied, through
  the three replay kernels."""
  return _replay.paint_vcg(_edge_ids(packed, nbytes, nodes, n_chains, sx,
                                     sy), sx, sy, permissible)


def decode_slices_to_ccl(packed, nbytes, nodes, n_chains, sx: int,
                         sy: int, permissible: bool):
  """Returns (cc (B, sy*sx) int32, N (B,) int32)."""
  vcg = _vcg_for_ccl(packed, nbytes, nodes, n_chains, sx, sy, permissible)
  cc, N, _ = _ccl.ccl_paint(vcg)
  return cc, N


def slice_rows(ids, piece_z, B: int):
  """Piece edge ids (P, CAP) int32 -> (B, kmax * CAP) int32 rows, row b
  holding the ids of every piece of slice b side by side and -1 after
  them (kmax: the most pieces of one slice). piece_z (P,) is each
  piece's slice, in order. paint_vcg takes ids in any order and sets the
  bit of each, so painting a row paints the bitwise OR of its pieces'
  edge bits: the reference merges them with a max
  (engine.py:249-250), which loses bits where two pieces set different
  ones of one pixel."""
  P, CAP = ids.shape
  pz = piece_z.to(torch.int64)
  count("host_syncs", 2 + bool(P))  # the any(), bincount's size, the max
  if P and bool((pz[1:] < pz[:-1]).any()):
    raise ValueError("slice_rows: piece_z is not in slice order")
  counts = torch.bincount(pz, minlength=B)
  kmax = max(int(counts.max()), 1) if B else 1
  slot = torch.arange(P, device=ids.device) - (
    torch.cumsum(counts, 0) - counts)[pz]
  rows = torch.full((B, kmax, CAP), -1, dtype=torch.int32,
                    device=ids.device)
  rows[pz, slot] = ids
  return rows.reshape(B, kmax * CAP)


def decode_pieces_to_vcg(packed, nbytes, nodes, n_chains, piece_z, B: int,
                         sx: int, sy: int, permissible: bool):
  """VCG (B, sy, sx) int32 of B slices split into P chain-aligned pieces:
  the pieces replay as rows of their own and each slice is painted from
  the edge ids of all its pieces (slice_rows)."""
  ids = _edge_ids(packed, nbytes, nodes, n_chains, sx, sy)
  return _replay.paint_vcg(slice_rows(ids, piece_z, B), sx, sy, permissible)


def decode_pieces_to_ccl(packed, nbytes, nodes, n_chains, piece_z, B: int,
                         sx: int, sy: int, permissible: bool):
  """The split decode of B slices (the reference's _split_ccl_step,
  engine.py:241-253). Returns (cc (B, sy*sx) int32, N (B,) int32)."""
  vcg = decode_pieces_to_vcg(packed, nbytes, nodes, n_chains, piece_z, B,
                             sx, sy, permissible)
  cc, N, _ = _ccl.ccl_paint(vcg)
  return cc, N


def labels_from_vcg(vcg, T):
  """The CCL and in-kernel label paint of a window's VCG (B, sy, sx)
  int32. T: (B, K, cap_n) int32 per-slice painted-value tables; K=1
  paints uint32 labels, K=2 paints uint64 labels as (lo32, hi32)
  planes. Returns (labels (B, sy*sx) uint32 or uint64, cc int32, N
  int32), all on vcg's device."""
  cc, N, painted = _ccl.ccl_paint(vcg, T)
  if T.shape[1] == 2:
    lo = painted[:, 0].to(torch.int64) & 0xFFFFFFFF
    hi = painted[:, 1].to(torch.int64) << 32
    labels = (lo | hi).view(torch.uint64)
  else:
    labels = painted[:, 0].contiguous().view(torch.uint32)
  return labels, cc, N


def decode_slices_full_plant(packed, nbytes, nodes, n_chains, T,
                             sx: int, sy: int, permissible: bool):
  """Decode with the in-kernel label paint: the replay, then
  labels_from_vcg. Returns (labels (B, sy*sx) uint32 or uint64, cc
  int32, N int32), all on the inputs' device."""
  return labels_from_vcg(
    _vcg_for_ccl(packed, nbytes, nodes, n_chains, sx, sy, permissible), T)


def pins_label_table(cc, pin_locs, pin_labs, single_ids, single_labs,
                     bg32: int, cap_n: int):
  """(B, cap_n + 2) int32 component -> label tables of a pins window
  (decode.py:498-505): bg32 everywhere, then the singles, then the
  label of each pin at the component its position holds in cc. Column
  cap_n takes the pads, as the reference's does; column cap_n + 1 takes
  what its mode='drop' scatter drops."""
  B = cc.shape[0]
  T = torch.full((B, cap_n + 2), bg32, dtype=torch.int32, device=cc.device)

  def put(tgt, vals):
    tgt = tgt.to(torch.int64)
    T.scatter_(1, torch.where((tgt >= 0) & (tgt <= cap_n), tgt,
                              cap_n + 1), vals)

  sid = single_ids.to(torch.int64)
  put(torch.where((sid >= 0) & (sid < cap_n), sid, cap_n), single_labs)
  ccv = torch.gather(cc, 1, torch.clamp(pin_locs.to(torch.int64), min=0))
  put(torch.where(pin_locs >= 0, ccv, cap_n), pin_labs)
  return T


def decode_slices_full_pins(packed, nbytes, nodes, n_chains, pin_locs,
                            pin_labs, single_ids, single_labs, bg32: int,
                            sx: int, sy: int, permissible: bool,
                            cap_n: int):
  """Decode a window of a condensed-pins stream (decode.py:457-522).

  The per-slice component -> label table is built on the device: each
  pin names the component it crosses with one gather from the CCL
  image, cc-singles name their components directly, and everything
  else is the background label bg32.

    pin_locs:    (B, P) int32 in-slice flat positions (-1 = pad)
    pin_labs:    (B, P) int32 label values (uint32 bitcast)
    single_ids:  (B, S) int32 window-local component ids (-1 = pad)
    single_labs: (B, S) int32

  The reference's default CCL here is v1 (decode.py:42-43), which runs
  the whole CCL twice per window: once for cc, once more to paint. The
  port takes v2 where cap_n <= PAINT_CAP_N: one converge pass whose
  rank pass also writes the roots (ccl_min_roots), and two plants from
  the same min-index image, the first for cc, the second for the
  labels. The outputs are the same; one whole CCL per window is saved.
  Past PAINT_CAP_N it takes the reference's else-branch: ccl_paint for
  cc, then a gather.

  Returns (labels (B, sy*sx) uint32, cc int32, N int32), all on the
  inputs' device."""
  return pins_labels_from_vcg(
    _vcg_for_ccl(packed, nbytes, nodes, n_chains, sx, sy, permissible),
    pin_locs, pin_labs, single_ids, single_labs, bg32, cap_n)


def pins_labels_from_vcg(vcg, pin_locs, pin_labs, single_ids, single_labs,
                         bg32: int, cap_n: int):
  """The CCL and label paint of decode_slices_full_pins on a window's
  VCG (B, sy, sx) int32, in two spans: decode.pins_ccl (the CCL and the
  first-visit ids), which counts the slices whose roots the CCL's rank
  pass wrote (pins_roots_fused; none past PAINT_CAP_N), and
  decode.pins_paint (the label table and the paint), which counts the
  window's pin and single table slots (pins_slots). Returns (labels
  (B, sy*sx) uint32, cc int32, N int32), all on vcg's device."""
  dev = vcg.device
  plant_ok = cap_n <= _ccl.PAINT_CAP_N
  with span("decode.pins_ccl", dev):
    if plant_ok:
      cap2 = _ccl._pow2_cap(cap_n)
      L, roots, N = _ccl.ccl_min_roots(vcg, cap2)
      count("pins_roots_fused", vcg.shape[0])
      cc, _ = _ccl.plant(L, roots)
    else:
      cc, N, _ = _ccl.ccl_paint(vcg)

  with span("decode.pins_paint", dev):
    count("pins_slots", pin_locs.numel() + single_ids.numel())
    T = pins_label_table(cc, pin_locs, pin_labs, single_ids, single_labs,
                         bg32, cap_n)
    if plant_ok:
      Tp = torch.nn.functional.pad(T[:, None, :cap_n], (0, cap2 - cap_n))
      _, painted = _ccl.plant(L, roots, Tp.contiguous())
      painted = painted[:, 0]
    else:
      painted = torch.gather(
        T, 1, torch.clamp(cc.to(torch.int64), 0, cap_n))
  return painted.contiguous().view(torch.uint32), cc, N


def paint_keys(cc, key_offsets, keys):
  """cc (B, n) window-local component ids -> uniq-index keys (B, n)
  int64 (decode.py:546-550, whose N argument is unused):
  keys[cc + key_offsets[:, None]], the indices clamped to the table as
  the reference's gather clamps them. key_offsets (B,) and keys are
  int64."""
  idx = cc.to(torch.int64) + key_offsets[:, None]
  return keys[idx.clamp_(0, keys.shape[0] - 1)]


def paint_labels_u32(cc, key_offsets, keys, uniq32):
  """The gather paint (decode.py:553-557): labels (B, n) uint32 =
  uniq[keys[cc + key_offsets]], uniq32 the labels' int32 bits."""
  return uniq32[paint_keys(cc, key_offsets, keys)].view(torch.uint32)


def decode_slices_full(packed, nbytes, nodes, n_chains, key_offsets, keys,
                       uniq32, sx: int, sy: int, permissible: bool):
  """Decode straight to labels of at most 32 bits through the gather
  paint, for slices of any component count (decode.py:525-543).
  key_offsets (B,) int64: each slice's first component in keys; keys
  int64: component -> uniq index; uniq32: the labels' int32 bits.
  Returns (labels (B, sy*sx) uint32, cc int32, N int32)."""
  cc, N = decode_slices_to_ccl(packed, nbytes, nodes, n_chains, sx, sy,
                               permissible)
  return paint_labels_u32(cc, key_offsets, keys, uniq32), cc, N
