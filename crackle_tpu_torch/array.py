"""Numpy-like facades over .ckl streams: the port of crackle_tpu/array.py.

CrackleArray holds the stream in host memory and CrackleRemoteArray reads
a stream by byte ranges (a path, or anything sliced to bytes), as the
reference's do (array.py:25-429); what they decode and encode goes
through the port's codec, so set_engine('torch') puts the kernels on the
card ('auto' with a card sends only pins, markov and label= windows
there: flat windows go to the native host decoder first, and numpy
encodes stay on the host), and their statistics run on the codec
engine's device. CrackleDeviceArray keeps the stream on a torch device
and returns its cutouts there (array.py:503-597).
"""
from typing import Dict, Optional, Union

import numpy as np
import torch

from . import operations
from .codec import (
  compress, condense_unique, contains, contains_range, decompress,
  decompress_range, header, labels, labels_for_z_range, nbytes, num_labels,
)
from .headers import CrackleHeader, LabelFormat
from .kernels import engine as _engine
from .lib import crc32c
from .operations import (
  add_scalar, array_equal, astype, connected_components, contacts,
  floordiv_scalar, mode_pooling_2x2x1, multiply_scalar, refit, remap,
  renumber, subtract_scalar, voxel_connectivity_graph, zsplit, zstack,
)
from .ops import analytics as _analytics


class CrackleArray:
  """A stream in host memory with numpy's indexing: cutouts decode only
  their z window and come back as host numpy in the header's order."""

  def __init__(self, binary: bytes, parallel: int = 0):
    self.binary = binary
    head = header(self.binary)
    self.shape = (head.sx, head.sy, head.sz)
    self.parallel = parallel

  def __len__(self):
    return len(self.binary)

  def header(self, ignore_crc_check: bool = False):
    return header(self.binary, ignore_crc_check=ignore_crc_check)

  @property
  def random_access(self):
    return True

  @property
  def size(self) -> int:
    return self.shape[0] * self.shape[1] * self.shape[2]

  @property
  def ndim(self) -> int:
    return sum(dim >= 0 for dim in self.shape)

  @property
  def nbytes(self) -> int:
    return nbytes(self.binary)

  def copy(self):
    return CrackleArray(self.binary)

  @property
  def dtype(self):
    return header(self.binary).dtype

  def labels(self, z: Optional[Union[int, slice]] = None):
    if z is not None:
      if isinstance(z, int):
        return labels_for_z_range(self.binary, z, z + 1)
      return labels_for_z_range(self.binary, z.start, z.stop)
    return labels(self.binary)

  def num_labels(self) -> int:
    return num_labels(self.binary)

  # the statistics run on the codec engine's device (the host loop where
  # no torch engine is enabled), not on the analytics functions' default
  def voxel_counts(self, label: Optional[int] = None) -> dict:
    return codec_analytics().voxel_counts(
      self.binary, label=label, parallel=self.parallel,
      device=_analytics._engine_device(),
    )

  def centroids(self, label: Optional[int] = None) -> dict:
    return codec_analytics().centroids(
      self.binary, label=label, parallel=self.parallel,
      device=_analytics._engine_device(),
    )

  def bounding_boxes(self, label: Optional[int] = None,
                     no_slice_conversion: bool = False) -> dict:
    return codec_analytics().bounding_boxes(
      self.binary, label=label,
      no_slice_conversion=no_slice_conversion, parallel=self.parallel,
      device=_analytics._engine_device(),
    )

  def min(self) -> int:
    return operations.min(self.binary)

  def max(self) -> int:
    return operations.max(self.binary)

  def remap(self, mapping: Dict[int, int],
            preserve_missing_labels: bool = False):
    return CrackleArray(remap(self.binary, mapping, preserve_missing_labels))

  def refit(self):
    return CrackleArray(refit(self.binary))

  def astype(self, dtype, order: str = 'K', casting: str = "unsafe"):
    return CrackleArray(astype(self.binary, dtype, order, casting))

  def renumber(self, start: int = 0):
    binary, mapping = renumber(self.binary, start)
    return CrackleArray(binary), mapping

  def numpy(self, *args, **kwargs) -> np.ndarray:
    return self.decompress(*args, **kwargs)

  def decompress(self, label: Optional[int] = None, crop: bool = False):
    return decompress(self.binary, label=label, parallel=self.parallel,
                      crop=crop)

  def condense(self) -> "CrackleArray":
    return CrackleArray(condense_unique(self.binary))

  def point_cloud(self, label: Optional[int] = None,
                  skip_background: bool = True,
                  z_start: int = -1, z_end: int = -1):
    return codec_analytics().point_cloud(
      self.binary, label, skip_background=skip_background,
      z_start=z_start, z_end=z_end, parallel=self.parallel,
    )

  def connected_components(self, connectivity: int = 26,
                           binary_image: bool = False,
                           memory_target: int = int(100e6),
                           progress: bool = False,
                           return_mapping: bool = False):
    out = connected_components(
      self.binary, connectivity=connectivity, binary_image=binary_image,
      memory_target=memory_target, progress=progress,
      return_mapping=return_mapping,
    )
    if return_mapping:
      return (CrackleArray(out[0]), out[1])
    return CrackleArray(out)

  def mode_pooling_2x2x1(self) -> "CrackleArray":
    return CrackleArray(
      mode_pooling_2x2x1(self.binary, parallel=self.parallel),
      parallel=self.parallel,
    )

  def voxel_connectivity_graph(self, connectivity: int = 4):
    return voxel_connectivity_graph(self.binary, connectivity,
                                    self.parallel)

  def contacts(self, anisotropy=(1.0, 1.0, 1.0)):
    return contacts(self.binary, anisotropy=anisotropy)

  def cache_meta(self, filelike):
    return codec_analytics().cache_meta(
      self.binary, filelike, parallel=self.parallel
    )

  def save(self, filelike):
    from . import util
    return util.save(self, filelike)

  def each(self, crop: bool = True, labels=None, multi: bool = False):
    return codec_analytics().each(
      self.binary, parallel=self.parallel, crop=crop, labels=labels,
      multi=multi,
    )

  def mask(self, labels: list, value: int = 0, in_place: bool = False):
    return CrackleArray(operations.mask(
      self.binary, labels=labels, value=value, in_place=in_place,
      parallel=self.parallel,
    ))

  def mask_except(self, labels: list, value: int = 0,
                  in_place: bool = False):
    return CrackleArray(operations.mask_except(
      self.binary, labels=labels, value=value, in_place=in_place,
      parallel=self.parallel,
    ))

  def array_equal(self, other: "CrackleArray") -> bool:
    return array_equal(self.binary, other.binary)

  def contains_range(self, low: int, high: int):
    return contains_range(self.binary, low, high)

  def __eq__(self, other):
    if isinstance(other, int):
      return self.min() == other and self.max() == other
    elif isinstance(other, CrackleArray):
      return self.array_equal(other)
    raise TypeError(f"Type {type(other)} is not supported.")

  def __add__(self, other: int):
    return CrackleArray(add_scalar(self.binary, other))

  def __radd__(self, other: int):
    return self.__add__(other)

  def __sub__(self, other: int):
    return CrackleArray(subtract_scalar(self.binary, other))

  def __rsub__(self, other: int):
    return self.__sub__(other)

  def __mul__(self, other: int):
    return CrackleArray(multiply_scalar(self.binary, other))

  def __rmul__(self, other: int):
    return self.__mul__(other)

  def __floordiv__(self, other: int):
    return CrackleArray(floordiv_scalar(self.binary, other))

  def __rfloordiv__(self, other: int):
    return self.__floordiv__(other)

  def __contains__(self, elem: int) -> bool:
    return contains(self.binary, elem)

  def __getitem__(self, slcs) -> np.ndarray:
    if slcs == (Ellipsis, np.newaxis):
      self.shape = self.shape + (1,)
      return self

    slices = reify_slices(slcs, *self.shape[:3])

    if isinstance(slcs, (slice, int)):
      slcs = (slcs,)
    while len(slcs) < 3:
      slcs += (slice(None, None, None),)

    img = decompress_range(
      self.binary, slices[2].start, slices[2].stop, parallel=self.parallel
    )
    zslc = slice(None, None, slices[2].step)
    if isinstance(slcs[2], (int, np.integer)):
      zslc = 0
    cutout = img[(slcs[0], slcs[1], zslc)]
    for _ in range(self.ndim - 3):
      cutout = cutout[..., np.newaxis]
    return cutout

  def __setitem__(self, slcs, data):
    if slcs == (Ellipsis, np.newaxis):
      self.shape = self.shape + (1,)
      return self

    slices = reify_slices(slcs, *self.shape[:3])
    if isinstance(slcs, (slice, int)):
      slcs = (slcs,)
    while len(slcs) < 3:
      slcs += (slice(None, None, None),)

    head = self.header()
    sz = slices[2].stop - slices[2].start

    if isinstance(data, (int, float)):
      data = np.full(
        [self.shape[0], self.shape[1], sz], data, dtype=head.dtype,
        order=('F' if head.fortran_order else 'C'),
      )

    if (slices[0] != slice(0, self.shape[0], 1)
        or slices[1] != slice(0, self.shape[1], 1)):
      tmp = self[:, :, slices[2].start:slices[2].stop]
      tmp[(slices[0], slices[1])] = data
      data = tmp

    if data.shape[2] != sz:
      raise ValueError(f"{data.shape[2]} did not match slice dimensions.")

    data_binary = compress(data.astype(head.dtype, copy=False))

    if slices[2] == slice(0, self.shape[2], 1):
      self.binary = data_binary
      return

    (before_0, _, _) = zsplit(self.binary, slices[2].start)
    if slices[2].stop >= self.shape[2]:
      mid_1, after_1 = b'', b''
      parts = [before_0, data_binary]
    else:
      (_, mid_1, after_1) = zsplit(self.binary, slices[2].stop)
      parts = [before_0, data_binary, mid_1, after_1]

    self.binary = zstack([p for p in parts if len(p)])


def codec_analytics():
  return _analytics


class CrackleRemoteArray(CrackleArray):
  """Ranged reads against remote storage: fetch the header, z-index and
  labels once, then read only each requested slice's crack bytes and
  synthesize a one-slice crackle file per access.

  filelike: anything with __getitem__(slice) -> bytes (e.g.
  cloudfiles.CloudFile) or a local file path.
  """

  def __init__(self, filelike, ignore_header_crc_check: bool = False):
    if isinstance(filelike, str):
      filelike = _LocalRangeReader(filelike)
    self.cf = filelike
    self.header_binary = self.cf[:CrackleHeader.HEADER_BYTES]
    self.header = header(
      self.header_binary, ignore_crc_check=ignore_header_crc_check
    )
    self.shape = (self.header.sx, self.header.sy, self.header.sz)
    self.parallel = 0
    self.z_index = None
    self.labels_binary = None
    self.markov_model = None
    self.crc_trailer = None

  def fetch_crc_trailer(self) -> bytes:
    """The trailing labels crc and per-slice crack crcs, so that the
    synthesized one-slice stream passes the decoder's crc checks, on
    the card too (the reference's remote array omits them)."""
    if self.header.format_version == 0:
      return b''
    if self.crc_trailer is None:
      n = (self.header.sz + 1) * 4
      self.crc_trailer = self.cf[-n:]
    return self.crc_trailer

  def labels(self):
    binary = self._synthetic_crackle_file(0, b'')
    return CrackleArray(binary).labels()

  def num_labels(self):
    hb = self.header.header_bytes
    offset = hb + self.header.grid_index_bytes
    sdw = self.header.stored_data_width
    if self.header.label_format == LabelFormat.FLAT:
      nl = self.cf[offset:offset + 8]
    else:
      nl = self.cf[offset + sdw:offset + sdw + 8]
    return int.from_bytes(nl, 'little')

  def __contains__(self, elem: int):
    binary = self._synthetic_crackle_file(0, b'')
    return elem in CrackleArray(binary)

  def fetch_z_index_labels_markov_model(self):
    hb = self.header.header_bytes
    z_offset = self.header.grid_index_bytes
    offset = (z_offset + self.header.num_label_bytes
              + self.header.num_markov_model_bytes)
    binary = self.cf[hb:hb + offset]

    z_index = np.frombuffer(
      binary[:self.header.sz * 4], dtype=np.uint32
    )
    lo = z_offset + self.header.num_label_bytes
    labels_binary = binary[z_offset:lo]
    markov_binary = binary[lo:lo + self.header.num_markov_model_bytes]

    z_index = np.cumsum(z_index.astype(np.uint64))
    z_index = np.concatenate([[0], z_index])
    z_index += (hb + self.header.num_label_bytes
                + self.header.grid_index_bytes
                + self.header.num_markov_model_bytes)
    return (z_index.astype(np.uint64), labels_binary, markov_binary)

  def fetch_markov_model(self):
    if self.header.markov_model_order == 0:
      return b''
    hb = self.header.header_bytes
    off = (hb + self.header.grid_index_bytes
           + self.header.num_label_bytes)
    return self.cf[off:off + self.header.num_markov_model_bytes]

  def fetch_all_labels(self) -> bytes:
    hb = self.header.header_bytes
    off = hb + self.header.grid_index_bytes
    return self.cf[off:off + self.header.num_label_bytes]

  def fetch_crack_code(self, z: int) -> bytes:
    return self.cf[int(self.z_index[z]):int(self.z_index[z + 1])]

  def _synthetic_crackle_file(self, z: int, crackcode: bytes,
                              labels_binary: Optional[bytes] = None
                              ) -> bytes:
    zindex = np.zeros((self.header.sz,), dtype=np.uint32)
    zindex[z] = len(crackcode)
    if labels_binary is None:
      labels_binary = self.labels_binary
    if labels_binary is None:
      labels_binary = self.fetch_all_labels()
    markov = self.markov_model
    if markov is None:
      markov = self.fetch_markov_model()

    gi = zindex.tobytes()
    if self.header.format_version > 0:
      gi += crc32c(gi).to_bytes(4, 'little')

    return b''.join([
      self.header_binary, gi, bytes(labels_binary), bytes(markov),
      crackcode, self.fetch_crc_trailer(),
    ])

  def __getitem__(self, z: int) -> np.ndarray:
    if self.z_index is None:
      (self.z_index, self.labels_binary, self.markov_model) = \
        self.fetch_z_index_labels_markov_model()
    crackcode = self.fetch_crack_code(z)
    binary = self._synthetic_crackle_file(z, crackcode)
    return CrackleArray(binary)[:, :, z]


class _LocalRangeReader:
  def __init__(self, path: str):
    self.path = path

  def __getitem__(self, slc) -> bytes:
    with open(self.path, 'rb') as f:
      start = slc.start or 0
      if start < 0:
        f.seek(start, 2)
      elif start:
        f.seek(start)
      if slc.stop is None:
        return f.read()
      return f.read(slc.stop - start)


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
        "CrackleArray for cutouts decoded through the codec, "
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
    return labels(self.binary)

  def num_labels(self) -> int:
    return num_labels(self.binary)

  def contains(self, label) -> bool:
    return contains(self.binary, label)

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
