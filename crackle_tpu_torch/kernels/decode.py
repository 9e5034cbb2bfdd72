"""Batched slice decode on a torch device.

Counterpart of crackle_tpu/kernels/decode.py: packed crack streams ->
VCG (replay kernels) -> first-visit CCL and label paint (CCL kernel).
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
  the three replay kernels and a sort of the keys."""
  keys, cls = _replay.replay_keys(packed, nbytes, n_chains)
  skeys = torch.sort(keys, dim=1).values
  ids = _replay.replay_positions(skeys, cls, nodes, sx, sy)
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
