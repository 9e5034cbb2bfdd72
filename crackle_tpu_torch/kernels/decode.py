"""Batched slice decode on a torch device.

Counterpart of crackle_tpu/kernels/decode.py: packed crack streams ->
VCG (replay kernels) -> first-visit CCL and label paint (CCL kernels).
Inputs are the tensors of engine.prepare_slice_inputs on one device:

  packed:   (B, CAP_B) uint8  packed move bytes (BOC stripped)
  nbytes:   (B,)       int32  valid byte count per slice
  nodes:    (B, CAP_CH) int32 chain start corner nodes
  n_chains: (B,)       int32  valid chain count per slice
"""
import torch

from . import ccl as _ccl
from . import replay as _replay


def _vcg_for_ccl(packed, nbytes, nodes, n_chains, sx: int, sy: int,
                 permissible: bool):
  """VCG (B, sy, sx) int32, crack-format complement applied, through
  the three replay kernels, or with replay.CANCEL_COMPACT through the
  compact-cancel kernels in place of replay_positions (the same edge
  ids), which read the events as the reference's sorted keys."""
  ev, cls, drange = _replay.replay_keys(packed, nbytes, n_chains)
  if _replay.CANCEL_COMPACT:
    skeys = _replay.sorted_keys(ev, cls)
    dense = _replay.cancel_sums(skeys)
    tables = _replay.compact_closes(
      dense, _replay.close_cap(skeys.shape[1], nodes.shape[1]))
    ids = _replay.replay_positions_compact(cls, tables, nodes, sx, sy)
  else:
    ids = _replay.replay_positions(ev, cls, drange, nodes, sx, sy)
  return _replay.paint_vcg(ids, sx, sy, permissible)


def decode_slices_to_ccl(packed, nbytes, nodes, n_chains, sx: int,
                         sy: int, permissible: bool):
  """Returns (cc (B, sy*sx) int32, N (B,) int32)."""
  vcg = _vcg_for_ccl(packed, nbytes, nodes, n_chains, sx, sy, permissible)
  cc, N, _ = _ccl.ccl_paint(vcg)
  return cc, N


def decode_slices_full_plant(packed, nbytes, nodes, n_chains, T,
                             sx: int, sy: int, permissible: bool):
  """Decode with the in-kernel label paint. T: (B, K, cap_n) int32
  per-slice painted-value tables; K=1 paints uint32 labels, K=2 paints
  uint64 labels as (lo32, hi32) planes. Returns (labels (B, sy*sx)
  uint32 or uint64, cc int32, N int32), all on the inputs' device."""
  vcg = _vcg_for_ccl(packed, nbytes, nodes, n_chains, sx, sy, permissible)
  cc, N, painted = _ccl.ccl_paint(vcg, T)
  if T.shape[1] == 2:
    lo = painted[:, 0].to(torch.int64) & 0xFFFFFFFF
    hi = painted[:, 1].to(torch.int64) << 32
    labels = (lo | hi).view(torch.uint64)
  else:
    labels = painted[:, 0].contiguous().view(torch.uint32)
  return labels, cc, N


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
  port takes v2 where cap_n <= PAINT_CAP_N: one converge pass
  (ccl_min), the roots, and two plants from the same min-index image,
  the first for cc, the second for the labels. The outputs are the
  same; one whole CCL per window is saved. Past PAINT_CAP_N it takes
  the reference's else-branch: ccl_paint for cc, then a gather.

  Returns (labels (B, sy*sx) uint32, cc int32, N int32), all on the
  inputs' device."""
  vcg = _vcg_for_ccl(packed, nbytes, nodes, n_chains, sx, sy, permissible)
  plant_ok = cap_n <= _ccl.PAINT_CAP_N
  if plant_ok:
    cap2 = _ccl._pow2_cap(cap_n)
    L, tgt = _ccl.ccl_min(vcg)
    roots, N = _ccl.roots_from_tgt(tgt, cap2)
    cc, _ = _ccl.plant(L, roots)
  else:
    cc, N, _ = _ccl.ccl_paint(vcg)

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
