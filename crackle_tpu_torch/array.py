"""A numpy-like facade over a compressed stream held on a torch device.

Counterpart of crackle_tpu/array.py:503-597 (CrackleDeviceArray), with
the port's copy of its slice helpers (array.py:432-500).
"""
import numpy as np
import torch

from . import codec
from .kernels import engine as _engine
from .ops import analytics as _analytics


def reify_slices(slices, sx, sy, sz):
  """Bind free slice attributes (None, Ellipsis) to this volume's
  bounds."""
  ndim = 3
  minpt = (0, 0, 0)
  maxpt = (sx, sy, sz)

  integer_types = (int, np.integer)
  floating_types = (float, np.floating)

  if isinstance(slices, integer_types) or isinstance(slices, floating_types):
    slices = [slice(int(slices), int(slices) + 1, 1)]
  elif isinstance(slices, slice):
    slices = [slices]
  elif slices is Ellipsis:
    slices = []

  slices = list(slices)

  for index, slc in enumerate(slices):
    if slc is Ellipsis:
      fill = ndim - len(slices) + 1
      slices = (slices[:index] + (fill * [slice(None, None, None)])
                + slices[index + 1:])
      break

  while len(slices) < ndim:
    slices.append(slice(None, None, None))
  while len(slices) > ndim and slices[-1] == slice(None, None, None):
    slices.pop()

  for index, slc in enumerate(slices):
    if isinstance(slc, integer_types) or isinstance(slc, floating_types):
      slc = int(slc)
      if slc < 0:
        slc += maxpt[index]
      slices[index] = slice(int(slc), int(slc) + 1, 1)
    elif slc == Ellipsis:
      raise ValueError("More than one Ellipsis operator used at once.")
    else:
      start = 0 if slc.start is None else slc.start
      end = maxpt[index] if slc.stop is None else slc.stop
      step = 1 if slc.step is None else slc.step
      if step < 0:
        raise ValueError(f'Negative step sizes are not supported. '
                         f'Got: {step}')
      if start < 0:
        start = maxpt[index] + start
      check_bounds(start, minpt[index], maxpt[index])
      if end < 0:
        end = maxpt[index] + end
      check_bounds(end, minpt[index], maxpt[index])
      slices[index] = slice(start, end, step)

  return slices


def clamp(val, low, high):
  return __import__('builtins').min(
    __import__('builtins').max(val, low), high
  )


def check_bounds(val, low, high):
  if val > high or val < low:
    raise ValueError(
      f'Value {val} cannot be outside of inclusive range {low} to {high}'
    )
  return val


class CrackleDeviceArray:
  """Read-only numpy-like facade over a compressed stream resident on a
  torch device (engine.DeviceStream).

  The parsed sections live on the device (about the compressed size)
  and every cutout decodes there, returning a tensor on the device with
  no host round trip. Flat and condensed-pins streams are taken, markov
  ones too (their rank decode is a host cost paid once, at upload).
  Raises ValueError where upload_stream declines the stream; label and
  metadata queries go to the host codec on the original bytes.
  parallel is the reference's keyword (array.py:518), stored and unused:
  device comes second, as the port's callers pass it."""

  def __init__(self, binary: bytes, device="cuda", parallel: int = 0):
    self.binary = binary
    self.parallel = parallel
    self.stream = _engine.upload_stream(binary, device)
    if self.stream is None:
      raise ValueError(
        "stream is not eligible for device serving (the "
        "crackle_tpu_torch.engine logger records the reason); use "
        "crackle_tpu_torch.codec.decompress or decompress_range for the "
        "volume, or the stream functions that need no upload "
        "(crackle_tpu_torch.voxel_counts, bounding_boxes, "
        "voxel_connectivity_graph, contacts, remap, mask, zsplit)")

  @property
  def device(self) -> torch.device:
    return self.stream.device

  @property
  def shape(self):
    head = self.stream.head
    return (head.sx, head.sy, head.sz)

  @property
  def dtype(self):
    return self.stream.head.dtype

  @property
  def ndim(self) -> int:
    return 3

  @property
  def nbytes_device(self) -> int:
    return self.stream.nbytes_device

  def header(self):
    return self.stream.head

  def labels(self):
    return codec.labels(self.binary)

  def num_labels(self) -> int:
    return codec.num_labels(self.binary)

  def contains(self, label) -> bool:
    return codec.contains(self.binary, label)

  def check_crcs(self) -> None:
    """Decode every slice and check its crack CRC32C on the device
    (raises FormatError on corruption)."""
    self.stream.decode_window(0, self.shape[2], check_crcs=True)

  def decode_window(self, z_start: int, z_end: int,
                    check_crcs: bool = False):
    """(labels, cc, N) tensors on the device for [z_start, z_end)."""
    return self.stream.decode_window(z_start, z_end, check_crcs=check_crcs)

  def __getitem__(self, slcs):
    """A cutout with CrackleArray's indexing semantics, as a tensor on
    the device (uint32, or uint64 for labels wider than 32 bits)."""
    sx, sy, sz = self.shape
    slices = reify_slices(slcs, sx, sy, sz)
    if isinstance(slcs, (slice, int, np.integer)):
      slcs = (slcs,)
    while len(slcs) < 3:
      slcs += (slice(None, None, None),)

    z0, z1 = slices[2].start, slices[2].stop
    labels, _cc, _N = self.stream.decode_window(z0, z1)
    vol = labels.reshape(z1 - z0, sy, sx).permute(2, 1, 0)
    zslc = slice(None, None, slices[2].step)
    if isinstance(slcs[2], (int, np.integer)):
      zslc = 0
    return vol[(slcs[0], slcs[1], zslc)]

  def voxel_counts(self, label=None):
    return _analytics.voxel_counts(self.binary, label=label,
                                   device=self.device)

  def centroids(self, label=None):
    return _analytics.centroids(self.binary, label=label,
                                device=self.device)

  def bounding_boxes(self, label=None, no_slice_conversion: bool = False):
    return _analytics.bounding_boxes(
      self.binary, label=label, no_slice_conversion=no_slice_conversion,
      device=self.device)

  def point_cloud(self, label=None):
    return _analytics.point_cloud(self.binary, label=label)
