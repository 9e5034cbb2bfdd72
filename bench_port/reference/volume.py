"""Voxel-exact comparison of decoded labels with the labels the volume
was made from, and the labels one step narrower that the controls
answer with."""
import numpy as np
import torch

_SIGNED = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}


def mismatches(labels, truth) -> int:
  """Voxels where labels ((B, sy * sx) or any shape of as many voxels, on
  a device) differ from truth ((sz, sy, sx), x fastest); every voxel
  where the shapes or dtypes differ."""
  if labels.dtype != truth.dtype or labels.numel() != truth.numel():
    return truth.numel()
  a = labels.reshape(-1).view(torch.uint8).reshape(truth.numel(), -1)
  b = truth.reshape(-1).view(torch.uint8).reshape(truth.numel(), -1)
  return int((a != b).any(1).sum())


def mismatches_host(out, want) -> int:
  """Voxels where a host answer out ((sx, sy, sz), any memory order)
  differs from want ((sz, sy, sx)); every voxel where the shapes or
  dtypes differ."""
  out = np.asarray(out)
  if out.dtype != want.dtype or out.shape != want.shape[::-1]:
    return want.size
  return int(np.count_nonzero(out.T != want))


def narrowed(x, bits: int):
  """Unsigned labels x stored in `bits` bits (fewer than their own) and
  read back at their own width: a tensor on x's device, or a numpy
  array."""
  if isinstance(x, np.ndarray):
    return x & x.dtype.type((1 << bits) - 1)
  wide = x.view(_SIGNED[x.element_size()])
  return (wide.to(torch.int64) & ((1 << bits) - 1)).to(wide.dtype).view(
    x.dtype)
