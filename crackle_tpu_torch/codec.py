"""Compress / decompress / decompression-free queries for .ckl streams.

Host orchestration layer (reference parity: crackle/codec.py,
src/crackle.hpp). The port's copy of crackle_tpu/codec.py: byte
plumbing stays on host, per-voxel work runs through the native library
or the vectorized numpy ops, and decompress reaches the torch decode
engine (crackle_tpu_torch.kernels.engine) as set_engine selects;
compress of a torch tensor (or of numpy input under 'torch') runs its
per-voxel stages on the device (crackle_tpu_torch.kernels.encode).
"""
import sys
from typing import Dict, Iterator, List, Optional, Tuple, Union
from collections import namedtuple

import numpy as np

from .headers import CrackleHeader, CrackFormat, LabelFormat, FormatError
from .lib import (
  compute_byte_width, compute_dtype, width2dtype, crc32c, itoc, ctoi,
)
from .ops import crackcode as _cc
from .ops import labels as _labels_ops
from .ops import pins as _pins_ops
from .ops.ccl import color_connectivity_graph_slice
from .models import markov as _markov
from .utils.profiling import annotate

PinTuple = namedtuple('Pin', ['index', 'depth'])

# Decode engine selection (the reference's set_engine, codec.py:29-52,
# with 'torch' for its 'jax'): 'auto' takes the torch engine on the
# card when torch.cuda.is_available(), after the native decoder for
# flat streams; 'numpy' forces the host engine; 'torch' forces the
# torch engine on its device (the card unless set_engine names another),
# and sends compress of numpy input to the device encode there.
_ENGINE = 'auto'
_DEVICE = 'cuda'


def set_engine(engine: str, device="cuda") -> None:
  """Select the decode engine (and, under 'torch', the encode's), and the
  torch engine's device."""
  global _ENGINE, _DEVICE
  if engine not in ('auto', 'numpy', 'torch'):
    raise ValueError(f"engine must be auto|numpy|torch, got {engine}")
  _ENGINE = engine
  _DEVICE = device


def get_engine() -> str:
  return _ENGINE


def _is_tensor(x) -> bool:
  torch = sys.modules.get("torch")
  return torch is not None and isinstance(x, torch.Tensor)


def _torch_engine_enabled() -> bool:
  if _ENGINE == 'numpy':
    return False
  if _ENGINE == 'torch':
    return True
  import torch
  return torch.cuda.is_available()


# ---------------------------------------------------------------------------
# Header / section accessors
# ---------------------------------------------------------------------------

@annotate("codec.parse")
def header(binary: bytes, ignore_crc_check: bool = False) -> CrackleHeader:
  """Decode the header from a Crackle bytestream."""
  return CrackleHeader.frombytes(binary, ignore_crc_check=ignore_crc_check)


def raw_labels(binary: bytes) -> np.ndarray:
  """The labels section as a zero-copy uint8 view."""
  head = header(binary)
  offset = head.header_bytes + head.grid_index_bytes
  return np.frombuffer(binary, dtype=np.uint8, offset=offset,
                       count=head.num_label_bytes)


def nbytes(binary: bytes) -> int:
  """Size in bytes of the decompressed array."""
  head = header(binary)
  return head.data_width * head.sx * head.sy * head.sz


def labels_crc(binary: bytes) -> Optional[int]:
  """Stored labels-section crc32c."""
  head = header(binary)
  if head.format_version == 0:
    return None
  crcl = head.sz * 4 + 4
  return int.from_bytes(binary[-crcl:-crcl + 4], 'little')


@annotate("codec.parse")
def crack_crcs(binary: bytes) -> Optional[np.ndarray]:
  """Stored per-slice crack crc32cs."""
  head = header(binary)
  if head.format_version == 0:
    return None
  crcl = head.sz * 4
  if crcl == 0:
    return np.zeros(0, dtype=np.uint32)
  return np.frombuffer(binary[-crcl:], dtype=np.uint32)


def components(binary: bytes) -> dict:
  head = header(binary)
  hl = head.header_bytes
  ll = head.num_label_bytes
  il = head.grid_index_bytes
  crcl = 0 if head.format_version == 0 else head.sz * 4 + 4
  cl = len(binary) - hl - ll - il - crcl
  cs = hl + ll + il
  return {
    'header': np.frombuffer(binary, count=hl, dtype=np.uint8),
    'z_index': np.frombuffer(binary, offset=hl, count=il, dtype=np.uint8),
    'labels': np.frombuffer(binary, offset=hl + il, count=ll, dtype=np.uint8),
    'crack_codes': np.frombuffer(binary, offset=cs, count=cl, dtype=np.uint8),
    'crcs': binary[len(binary) - crcl:] if crcl else b'',
  }


def component_lengths(binary: bytes) -> dict:
  return {k: len(v) for k, v in components(binary).items()}


def grid_index(binary: bytes, ignore_crc_check: bool = False) -> np.ndarray:
  """Byte offsets into the stream for each slice's crack code."""
  head = header(binary)
  offset = head.header_bytes
  z_index_binary = np.frombuffer(
    binary, offset=offset, count=head.grid_index_bytes, dtype=np.uint8
  )
  if head.format_version == 0:
    z_index = np.frombuffer(z_index_binary, dtype=np.uint32)
  else:
    z_index = np.frombuffer(z_index_binary[:-4], dtype=np.uint32)
    if not ignore_crc_check:
      stored = int.from_bytes(z_index_binary[-4:], 'little')
      computed = crc32c(bytes(z_index_binary[:-4]))
      if stored != computed:
        raise FormatError(
          f"Grid index crc32c did not match stored version. "
          f"Stored: {stored} Computed: {computed}"
        )
  z_index = np.concatenate([[0], z_index]).astype(np.uint64)
  z_index = np.cumsum(z_index)
  z_index += head.header_bytes + head.num_label_bytes + head.grid_index_bytes
  if head.markov_model_order > 0:
    z_index += head.num_markov_model_bytes
  return z_index.astype(np.uint64, copy=False)


@annotate("codec.parse")
def crack_codes(binary: bytes) -> List[bytes]:
  head = header(binary)
  z_index = grid_index(binary)
  return [
    binary[int(z_index[i]):int(z_index[i + 1])] for i in range(head.sz)
  ]


def boc(crack_code: bytes) -> bytes:
  """The beginning-of-chain index region of one slice's crack code."""
  N = int.from_bytes(crack_code[:4], 'little')
  return crack_code[:N + 4]


def background_color(binary: bytes) -> int:
  """For pin encodings only: the background color."""
  head = header(binary)
  if head.label_format == LabelFormat.FLAT:
    raise FormatError(
      "Background color can only be extracted from pin encoded streams."
    )
  offset = head.header_bytes + head.grid_index_bytes
  return ctoi(binary, offset, head.stored_data_width)


# ---------------------------------------------------------------------------
# Label queries (no decompression)
# ---------------------------------------------------------------------------

def labels(binary: bytes) -> np.ndarray:
  """Sorted unique labels of the volume."""
  head = header(binary)
  if head.voxels() == 0:
    return np.zeros((0,), dtype=head.dtype)
  lb = bytes(raw_labels(binary))
  uniq = _labels_ops.decode_uniq(head, lb)
  if head.label_format != LabelFormat.FLAT:
    bg = background_color(binary)
    uniq = np.concatenate([[bg], uniq]).astype(uniq.dtype)
    uniq.sort()
  return uniq.astype(head.dtype, copy=False)


@annotate("codec.parse")
def num_labels(binary: bytes) -> int:
  """Number of unique labels."""
  head = header(binary)
  if head.voxels() == 0:
    return 0
  lb = bytes(raw_labels(binary))
  n = _labels_ops.decode_num_labels(head, lb)
  if head.label_format != LabelFormat.FLAT:
    n += 1  # bgcolor
  return n


def labels_for_z_range(binary: bytes, z_start: int, z_end: int) -> np.ndarray:
  """Unique labels within a z window (flat format only)."""
  head = header(binary)
  if head.voxels() == 0:
    return np.zeros((0,), dtype=head.dtype)
  if head.label_format != LabelFormat.FLAT:
    raise FormatError("Not implemented for pins.")
  parts = decode_flat_labels(head, binary)
  cpg = np.concatenate([[0], np.cumsum(parts["components_per_grid"])])
  section = parts["cc_map"][int(cpg[z_start]):int(cpg[z_end])]
  out = parts["unique"][np.unique(section)]
  if not head.is_sorted:
    out = np.sort(out)
  return out.astype(head.dtype, copy=False)


def contains(binary: bytes, label: int) -> bool:
  """Rapidly check if a label exists in the stream."""
  head = header(binary)
  if head.voxels() == 0:
    return False
  if not head.is_sorted:
    return label in labels(binary)
  if head.label_format == LabelFormat.PINS_VARIABLE_WIDTH:
    if background_color(binary) == label:
      return True
  lb = bytes(raw_labels(binary))
  uniq = _labels_ops.decode_uniq(head, lb)
  try:
    label = np.asarray(label, dtype=uniq.dtype)
  except OverflowError:
    return False
  idx = np.searchsorted(uniq, label)
  if 0 <= idx < uniq.size:
    return bool(uniq[idx] == label)
  return False


def contains_range(binary: bytes, low: int, high: int) -> np.ndarray:
  """Labels present in [low, high)."""
  head = header(binary)
  if low >= high:
    return np.zeros([0], dtype=head.stored_dtype)
  if not head.is_sorted:
    arr = labels(binary)
    return arr[(arr >= low) & (arr < high)]
  bg_arr = np.zeros([0], dtype=head.stored_dtype)
  if head.label_format == LabelFormat.PINS_VARIABLE_WIDTH:
    bg = background_color(binary)
    if low <= bg < high:
      bg_arr = np.array([bg], dtype=head.stored_dtype)
  lb = bytes(raw_labels(binary))
  uniq = _labels_ops.decode_uniq(head, lb)
  try:
    np.asarray(low, dtype=uniq.dtype)
  except OverflowError:
    return bg_arr
  idx_low = np.searchsorted(uniq, low)
  idx_high = np.searchsorted(uniq, high)
  return np.concatenate([bg_arr, uniq[idx_low:idx_high]])


def decode_flat_labels(head: CrackleHeader, binary: bytes) -> dict:
  """Parse the flat labels section into its arrays."""
  if head.label_format != LabelFormat.FLAT:
    raise FormatError("Must be flat labels format.")
  lb = bytes(raw_labels(binary))
  n = _labels_ops.decode_num_labels(head, lb)
  uniq = labels(binary)
  cpg = _labels_ops.components_per_grid(head, lb)
  offset = 8 + n * head.stored_data_width + cpg.nbytes
  cc_map = np.frombuffer(lb, offset=offset, dtype=compute_dtype(n))
  return {
    "num_labels": n,
    "unique": uniq,
    "components_per_grid": cpg,
    "cc_map": cc_map,
  }


def extract_keys(binary: bytes) -> np.ndarray:
  head = header(binary)
  if head.label_format != LabelFormat.FLAT:
    raise FormatError("Can't use this function except with FLAT labels.")
  N = num_labels(binary)
  raw = bytes(raw_labels(binary))
  idx_bytes = head.component_width() * head.sz
  offset = 8 + N * head.stored_data_width + idx_bytes
  key_width = compute_byte_width(N)
  return np.frombuffer(raw, offset=offset, dtype=f'u{key_width}')


def decode_condensed_pins_components(binary: bytes) -> dict:
  head = header(binary)
  if head.label_format != LabelFormat.PINS_VARIABLE_WIDTH:
    raise FormatError(
      "This function can only extract pins from variable width streams."
    )
  lb = bytes(raw_labels(binary))
  layout = _labels_ops.decode_condensed_pins_layout(head, lb)
  layout["cc_labels_width"] = layout.pop("cc_label_width")
  layout["pinset"] = np.frombuffer(
    lb, offset=layout.pop("pinset_offset"), dtype=np.uint8
  )
  return layout


def decode_condensed_pins(binary: bytes) -> Tuple[dict, dict]:
  head = header(binary)
  if head.label_format != LabelFormat.PINS_VARIABLE_WIDTH:
    raise FormatError(
      "This function can only extract pins from variable width streams."
    )
  lb = bytes(raw_labels(binary))
  pins_raw, singles = _labels_ops.decode_condensed_pins(head, lb)
  pins = {
    label: [PinTuple(i, d) for i, d in pairs]
    for label, pairs in pins_raw.items()
  }
  return pins, singles


def decode_pins(binary: bytes):
  head = header(binary)
  if head.label_format == LabelFormat.PINS_VARIABLE_WIDTH:
    return decode_condensed_pins(binary)[0]
  raise FormatError("Cannot decode pins from flat format.")


# ---------------------------------------------------------------------------
# z-range queries
# ---------------------------------------------------------------------------

def z_range_for_label(binary: bytes, label: int) -> Tuple[int, int]:
  head = header(binary)
  if head.label_format == LabelFormat.FLAT:
    return z_range_for_label_flat(binary, label)
  elif head.label_format == LabelFormat.PINS_VARIABLE_WIDTH:
    return z_range_for_label_condensed_pins(binary, label)
  raise ValueError("Label format not supported.")


def z_range_for_label_flat(binary: bytes, label: int) -> Tuple[int, int]:
  head = header(binary)
  lb = bytes(raw_labels(binary))
  uniq = _labels_ops.decode_uniq(head, lb)
  try:
    label = np.asarray(label, dtype=uniq.dtype)
    idx = np.searchsorted(uniq, label)
  except OverflowError:
    idx = -1
  if idx < 0 or idx >= uniq.size or uniq[idx] != label:
    return (-1, -1)

  cpg = np.cumsum(
    _labels_ops.components_per_grid(head, lb).astype(np.int64)
  )
  n = len(uniq)
  offset = 8 + n * head.stored_data_width + \
      head.num_grids() * head.component_width()
  cc_labels = np.frombuffer(lb, offset=offset, dtype=compute_dtype(n))

  cc_idxs = np.flatnonzero(cc_labels == idx)
  if cc_idxs.size == 0:
    return (-1, -1)
  min_cc, max_cc = int(cc_idxs[0]), int(cc_idxs[-1])

  z_start = int(np.searchsorted(cpg, min_cc))
  z_end = int(np.searchsorted(cpg, max_cc))
  if cpg[z_start] == min_cc:
    z_start = min(z_start + 1, head.sz - 1)
  if cpg[z_end] == max_cc:
    z_end = min(z_end + 1, head.sz - 1)
  return (int(z_start), int(z_end + 1))


def z_range_for_label_condensed_pins(binary: bytes,
                                     label: int) -> Tuple[int, int]:
  head = header(binary)
  lb = bytes(raw_labels(binary))
  bg = background_color(binary)
  if bg == label:
    return (0, head.sz)
  layout = _labels_ops.decode_condensed_pins_layout(head, lb)
  uniq = layout["uniq"]
  try:
    label_arr = np.asarray(label, dtype=uniq.dtype)
    idx = np.searchsorted(uniq, label_arr)
  except OverflowError:
    idx = -1
  if idx < 0 or idx >= uniq.size or uniq[idx] != label:
    return (-1, -1)

  cpg = np.cumsum(layout["components_per_grid"].astype(np.int64))
  all_pins, all_singles = decode_condensed_pins(binary)
  label_pins = all_pins[int(label)]
  singles = all_singles[int(label)]

  z_start = head.sz - 1
  z_end = 0
  sxy = head.sx * head.sy
  for pin in label_pins:
    z = pin.index // sxy
    z_start = min(z_start, z)
    z_end = max(z_end, z + pin.depth + 1)

  if len(singles) == 0:
    return (int(z_start), int(z_end))

  for lbl in [singles[0], singles[-1]]:
    z = int(np.searchsorted(cpg, np.asarray(lbl, dtype=cpg.dtype),
                            side='right'))
    z_start = min(z_start, z)
    z_end = max(z_end, z)

  z_start = max(z_start, 0)
  z_end = min(z_end + 2, head.sz)
  return (int(z_start), int(z_end))


# ---------------------------------------------------------------------------
# DECODE
# ---------------------------------------------------------------------------

@annotate("codec.parse")
def decode_markov_model(head: CrackleHeader, binary: bytes) -> Optional[np.ndarray]:
  if head.markov_model_order == 0:
    return None
  offset = head.header_bytes + head.grid_index_bytes + head.num_label_bytes
  stored = binary[offset:offset + head.num_markov_model_bytes]
  return _markov.from_stored_model(stored, head.markov_model_order)


def slice_crack_code_to_vcg(code: bytes, head: CrackleHeader,
                            markov_model=None) -> np.ndarray:
  """One slice's crack code bytes -> voxel connectivity graph."""
  sx, sy = head.sx, head.sy
  permissible = head.crack_format == CrackFormat.PERMISSIBLE
  if markov_model is None:
    return _cc.slice_code_to_vcg(code, sx, sy, permissible)
  if len(code) == 0:
    base = 0 if permissible else 0b1111
    return np.full(sx * sy, base, dtype=np.uint8)
  index_size = 4 + ctoi(code, 0, 4)
  nodes = _cc.read_boc_index(code, sx, sy)
  cps = _markov.decode_markov(
    code[index_size:], markov_model, head.markov_model_order
  )
  return _cc.codepoints_to_vcg(cps, nodes, sx, sy, permissible)


def decode_slice_vcg(binary: bytes, z: int) -> np.ndarray:
  """Decode one slice's VCG (debugging / analytics entry point)."""
  head = header(binary)
  if z < 0 or z >= head.sz:
    raise ValueError(f"crackle: Invalid z: {z}")
  model = decode_markov_model(head, binary)
  code = crack_codes(binary)[z]
  return slice_crack_code_to_vcg(code, head, model)


def _decode_slice_ccl(code: bytes, head: CrackleHeader, markov_model,
                      stored_crc: Optional[int], z: int):
  """crack code -> (window-local CCL image, N). Checks the per-slice
  crc32c over the uint32 CCL labels like the reference decoder."""
  vcg = slice_crack_code_to_vcg(code, head, markov_model)
  cc_labels, N = color_connectivity_graph_slice(vcg, head.sx, head.sy)
  if stored_crc is not None:
    computed = crc32c(np.ascontiguousarray(cc_labels, dtype='<u4'))
    if computed != stored_crc:
      raise FormatError(
        f"crackle: crack code crc mismatch on z={z} "
        f"computed: {computed} stored: {stored_crc}"
      )
  return cc_labels, N


def _full_decode(binary: bytes, z_start: int, z_end: int,
                 label: Optional[int] = None) -> np.ndarray:
  """Decode of a z window (crackle.hpp decompress parity).

  The destination is host memory, so in auto mode the native C++
  stream decoder goes first: it produces the array in place with crcs
  checked, where the torch engine would decode on the card and then
  copy the volume back. The pins, markov and label-query streams that
  it rejects go to the torch engine (engine.decode_window) where it is
  enabled, and set_engine('torch') sends every stream there first.
  Where the engine declines, the reason is logged and the host path
  below takes the window.
  """
  head = header(binary)

  def _native():
    if label is not None or head.label_format != LabelFormat.FLAT:
      return None
    from . import native
    try:
      return native.decompress_stream(
        binary, z_start, z_end, (head.sx, head.sy, head.sz),
        head.data_width, head.fortran_order,
      )
    except ValueError as e:
      raise FormatError(str(e))

  if _ENGINE != 'torch':
    out = _native()
    if out is not None:
      return out
  if _torch_engine_enabled():
    from .kernels import engine as _engine
    out = _engine.decode_window(binary, z_start, z_end, label=label,
                                device=_DEVICE)
    if out is not None:
      return out
    _engine._fallback("decompress", "the torch engine declined the window")
  if _ENGINE == 'torch':
    out = _native()
    if out is not None:
      return out
  sx, sy = head.sx, head.sy
  sxy = sx * sy
  szr = z_end - z_start
  out_dtype = np.dtype(bool) if label is not None else head.dtype

  model = decode_markov_model(head, binary)
  codes = crack_codes(binary)
  crcs = crack_crcs(binary)
  lb = bytes(raw_labels(binary))

  out = np.empty((szr, sy, sx), dtype=out_dtype)

  for zi in range(szr):
    z = z_start + zi
    stored_crc = int(crcs[z]) if crcs is not None else None
    cc_labels, N = _decode_slice_ccl(codes[z], head, model, stored_crc, z)
    if head.label_format == LabelFormat.FLAT:
      label_map = _labels_ops.decode_flat(head, lb, z, z + 1, head.dtype)
    else:
      label_map = _labels_ops.decode_condensed_pins_label_map(
        head, lb, cc_labels, N, z, z + 1, head.dtype
      )
    slab = label_map[cc_labels]
    if label is not None:
      slab = slab == label
    out[zi] = slab.reshape(sy, sx)

  # out is [z][y][x]; produce (sx, sy, szr)
  arr = out.transpose(2, 1, 0)
  if head.fortran_order:
    return np.asfortranarray(arr)
  return np.ascontiguousarray(arr)


@annotate("codec.decompress")
def decompress_range(binary: bytes, z_start: Optional[int],
                     z_end: Optional[int], parallel: int = 0,
                     label: Optional[int] = None) -> np.ndarray:
  """Decompress a z window of a Crackle stream."""
  head = header(binary)
  sx, sy, sz = head.sx, head.sy, head.sz

  if z_start is None:
    z_start = 0
  if z_end is None:
    z_end = sz
  z_start = max(min(int(z_start), sz - 1), 0) if sz else 0
  z_end = int(z_end)
  z_end = max(min(z_end, sz), 0)
  if sz and z_start >= z_end:
    raise ValueError(f"crackle: Invalid range: {z_start} - {z_end}")

  order = 'F' if head.fortran_order else 'C'
  shape = (sx, sy, z_end - z_start)

  if sx * sy * sz == 0:
    arr = np.zeros((0,), dtype=head.dtype)
    return arr.reshape((sx, sy, max(z_end - z_start, 0)), order=order)
  elif label is not None and not contains(binary, label):
    arr = np.zeros(shape, order=order, dtype=bool)
  elif label is None and num_labels(binary) == 1:
    single = labels(binary)[0]
    if single == 0:
      arr = np.zeros(shape, order=order, dtype=head.dtype)
    else:
      arr = np.full(shape, single, order=order, dtype=head.dtype)
  else:
    arr = _full_decode(binary, z_start, z_end, label)

  if label is not None:
    return arr.view(bool) if arr.dtype != bool else arr
  if head.signed:
    arr = arr.view(head.dtype)
  return arr


def decompress_binary_image(binary: bytes, label: int, parallel: int = 0,
                            crop: bool = True) -> np.ndarray:
  z_start, z_end = z_range_for_label(binary, label)
  head = header(binary)
  order = "F" if head.fortran_order else "C"

  if z_start == -1 and z_end == -1 and crop:
    return np.zeros([0, 0, 0], dtype=bool, order=order)
  if (z_start == 0 and z_end == head.sz) or crop:
    return decompress_range(binary, z_start, z_end, parallel, label)

  image = np.zeros([head.sx, head.sy, head.sz], dtype=bool, order=order)
  if z_start == -1 and z_end == -1:
    return image
  image[:, :, z_start:z_end] = decompress_range(
    binary, z_start, z_end, parallel, label
  )
  return image


@annotate("codec.decompress")
def decompress(binary: bytes, label: Optional[int] = None,
               parallel: int = 0, crop: bool = False) -> np.ndarray:
  """Decompress a Crackle binary into a numpy array. If label is
  given, produce a boolean mask for that label (optionally z-cropped)."""
  if label is None:
    return decompress_range(binary, None, None, parallel)
  return decompress_binary_image(binary, label, parallel, crop=crop)


# ---------------------------------------------------------------------------
# COMPRESS
# ---------------------------------------------------------------------------

def _encode_boundaries(labels_f: np.ndarray, sx: int, sy: int, sz: int,
                       permissible: bool, parallel: int = 0):
  """Per-slice crack tracing, thread-pooled over z like the
  reference's encode_boundaries (crackcodes.hpp:498-521): the native
  tracer releases the GIL, so slices run concurrently."""
  sxy = sx * sy

  def one(z):
    return _cc.create_crack_codes(labels_f[z * sxy:(z + 1) * sxy],
                                  sx, sy, permissible)

  n_threads = _pool_size(parallel, sz)
  if n_threads <= 1 or sz <= 1:
    return [one(z) for z in range(sz)]
  from concurrent.futures import ThreadPoolExecutor
  with ThreadPoolExecutor(n_threads) as pool:
    return list(pool.map(one, range(sz)))


def _pool_size(parallel: int, n_items: int) -> int:
  """parallel=0 means all cores (crackle.hpp:66-69 parity)."""
  import os as _os
  n = parallel if parallel > 0 else (_os.cpu_count() or 1)
  return max(1, min(n, n_items))


def _encode_flat_fused(flat, sx, sy, sz, stored_dtype, permissible,
                       parallel):
  """One pooled pass per slice through the fused native encode step
  (trace + pack + CCL + mapping in a single C call, GIL released),
  then the global uniq/keys assembly. Byte-identical to the
  trace/pack/encode_flat pipeline; returns (crack_code_bytes,
  labels_binary, crack_crcs) or None to fall back."""
  from . import native
  if not native.available():
    return None
  sxy = sx * sy
  codes: list = [None] * sz
  maps: list = [None] * sz
  nums = np.zeros(sz, dtype=np.uint64)
  crcs = np.zeros(sz, dtype=np.uint32)
  failed: list = []

  def one(z):
    res = native.encode_slice(
      flat[z * sxy:(z + 1) * sxy], sx, sy, permissible)
    if res is None:
      failed.append(z)
      return
    code, cc, mapping, n = res
    codes[z] = code
    crcs[z] = crc32c(cc)  # before the thread reuses the cc scratch
    maps[z] = mapping
    nums[z] = n

  n_threads = _pool_size(parallel, sz)
  if n_threads <= 1 or sz <= 1:
    for z in range(sz):
      one(z)
  else:
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(n_threads) as pool:
      list(pool.map(one, range(sz)))
  if failed:
    return None

  mapping = np.concatenate(maps) if sz else np.zeros(0, np.uint64)
  return codes, flat_labels_section(mapping, nums, sxy, stored_dtype), crcs


def flat_labels_section(mapping, nums, sxy: int, stored_dtype) -> bytes:
  """The flat labels section: the sorted unique labels, each slice's
  component count and each component's key into the unique labels.
  mapping: every slice's component labels in turn, uint64; nums: (sz,)
  components a slice."""
  uniq = np.unique(mapping)
  keys = np.searchsorted(uniq, mapping)
  key_width = compute_byte_width(len(uniq))
  component_width = compute_byte_width(sxy)
  return b''.join([
    itoc(len(uniq), 8),
    np.ascontiguousarray(uniq.astype(stored_dtype)).tobytes(),
    np.ascontiguousarray(
      np.asarray(nums).astype(np.uint64)
      .astype(width2dtype[component_width])).tobytes(),
    np.ascontiguousarray(
      keys.astype(width2dtype[key_width])).tobytes(),
  ])


def container(head: CrackleHeader, codes, labels_binary: bytes, crcs,
              stored_model: bytes = b'') -> bytes:
  """The .ckl bytes: the header (its num_label_bytes set here), the z
  index and its CRC, the labels section, the markov model, each slice's
  crack code, the labels section's CRC and each slice's CRC (crcs)."""
  head.num_label_bytes = len(labels_binary)
  z_index = np.array([len(c) for c in codes], dtype='<u4').tobytes()
  z_index += itoc(crc32c(z_index), 4)
  return b''.join([
    head.tobytes(),
    z_index,
    labels_binary,
    stored_model,
    *codes,
    itoc(crc32c(labels_binary), 4),
    np.asarray(crcs, dtype='<u4').tobytes(),
  ])


def stream_header(shape, data_width: int, max_label: int, num_pairs: int,
                  fortran_order: bool, allow_pins: int = 0,
                  markov_model_order: int = 0) -> CrackleHeader:
  """The header compress writes for labels of `shape` (sx, sy, sz) whose
  largest label is max_label and whose flat F-order pixel pairs number
  num_pairs: the crack format from the pairs, condensed pins where they
  are allowed, the pairs pick the impermissible format and sz is not 1,
  and the stored width from max_label. The host and device encoders
  both take their format decision here."""
  sx, sy, sz = shape
  # integer division matches the reference (crackle.hpp:52 divides
  # int64s), and the native/wasm encoders already use it — for odd
  # voxel counts with num_pairs == voxels // 2 float division would
  # pick the other crack format and break byte-identity
  permissible = num_pairs < sx * sy * sz // 2
  pins = bool(allow_pins) and not permissible and sz != 1
  return CrackleHeader(
    label_format=(LabelFormat.PINS_VARIABLE_WIDTH if pins
                  else LabelFormat.FLAT),
    crack_format=(CrackFormat.PERMISSIBLE if permissible
                  else CrackFormat.IMPERMISSIBLE),
    data_width=data_width,
    stored_data_width=compute_byte_width(max_label),
    sx=sx, sy=sy, sz=sz,
    num_label_bytes=0,
    fortran_order=fortran_order,
    grid_size=2 ** 31,
    signed=False,
    markov_model_order=markov_model_order,
    is_sorted=True,
  )


@annotate("codec.compress")
def compress(labels: np.ndarray, allow_pins: int = 0,
             markov_model_order: int = 0, bgcolor: Optional[int] = None,
             parallel: int = 0, optimize_pins: Optional[bool] = None
             ) -> bytes:
  """Compress a 3D labels array, or a torch tensor on any device, into a
  Crackle bytestream.

  allow_pins: 0 disabled, 1 fast pin solver, 2 greedy-optimal solver.
  markov_model_order: order of the optional crack-code context model.
  bgcolor: manual background color for pin encoding.
  """
  is_tensor = _is_tensor(labels)
  if is_tensor:
    import torch
    signed = labels.dtype in (torch.int8, torch.int16, torch.int32,
                              torch.int64)
  else:
    signed = np.issubdtype(np.dtype(str(labels.dtype)), np.signedinteger)
  if signed:
    raise TypeError("Signed integer data types are not currently supported.")
  if labels.ndim > 3:
    raise ValueError(f"{labels.ndim}d arrays are not supported.")

  if optimize_pins is None:
    optimize_pins = (allow_pins == 2)

  # A torch tensor, or any input under set_engine('torch'): the
  # per-voxel encode stages (VCG, CCL, label tables, CRC32C) and, for
  # the fast pins solver, the pins' column scan and cover index run on
  # the tensor's device, or the engine's for numpy input, and only the
  # serial trace, the pins' pick order and the assembly on the host
  # (kernels/encode.py). Numpy and CPU tensors fall through to the host
  # path where the device encode declines; labels on a card raise there,
  # and reach the host path only for the optimal pins solver, markov or
  # another rank, or when they are empty.
  if is_tensor or _ENGINE == 'torch':
    from .kernels import encode as _enc
    if (labels.ndim == 3 and markov_model_order == 0
        and not (allow_pins and optimize_pins)):
      forder = is_tensor or bool(labels.flags.f_contiguous)
      dev = labels.device if is_tensor else _DEVICE
      if allow_pins:
        out = _enc.encode_pins_device(labels, parallel=parallel,
                                      fortran_order=forder, device=dev,
                                      bgcolor=bgcolor)
      else:
        out = _enc.encode_flat_device(labels, parallel=parallel,
                                      fortran_order=forder, device=dev)
      if out is not None:
        return out
      if is_tensor and labels.device.type != 'cpu' and labels.numel():
        raise RuntimeError(
          f"compress: the device encode declined the labels on "
          f"{labels.device}: "
          f"{_enc.decline_reason(labels) or 'the native trace overflowed'}"
          f"; move them to the CPU for the host encoder")
    if is_tensor:
      # the device encode writes fortran_order=True for a tensor; so
      # does the host path (pins, markov, other ranks)
      labels = np.asfortranarray(_enc.host_labels(labels))

  while labels.ndim < 3:
    labels = labels[..., np.newaxis]

  f_order = labels.flags.f_contiguous
  labels = np.asfortranarray(labels)
  auto_bgcolor = bgcolor is None
  manual_bgcolor = 0 if bgcolor is None else int(bgcolor)

  sx, sy, sz = labels.shape
  voxels = sx * sy * sz
  flat = labels.ravel(order='F')

  max_label = int(flat.max()) if voxels else 0
  num_pairs = int(np.count_nonzero(flat[1:] == flat[:-1])) if voxels else 0
  head = stream_header((sx, sy, sz), labels.dtype.itemsize, max_label,
                       num_pairs, f_order, allow_pins, markov_model_order)
  stored_dtype = width2dtype[head.stored_data_width]
  label_format = head.label_format

  if voxels == 0:
    return head.tobytes()

  permissible = head.crack_format == CrackFormat.PERMISSIBLE

  if (head.markov_model_order == 0
      and label_format == LabelFormat.FLAT):
    fused = _encode_flat_fused(
      flat, sx, sy, sz, stored_dtype, permissible, parallel)
    if fused is not None:
      return container(head, *fused)

  chains_per_z = _encode_boundaries(flat, sx, sy, sz, permissible,
                                    parallel)

  if head.markov_model_order > 0:
    if all(len(c) == 0 for c in chains_per_z):
      head.markov_model_order = 0

  stored_model = b''
  if head.markov_model_order > 0:
    diff_streams = []
    for chains in chains_per_z:
      _, cps = _cc.concat_chain_codepoints(chains)
      diff_streams.append(_cc.difference_code(cps))
    stats = _markov.gather_statistics(diff_streams, head.markov_model_order)
    model = _markov.stats_to_model(stats)
    stored_model = _markov.to_stored_model(model)
    crack_code_bytes = [
      _markov.compress_slice(chains, model, head.markov_model_order, sx, sy)
      for chains in chains_per_z
    ]
  else:
    crack_code_bytes = [
      _cc.pack_codepoints(chains, sx, sy) for chains in chains_per_z
    ]

  if label_format == LabelFormat.PINS_VARIABLE_WIDTH:
    all_pins, num_per_slice, n_total, crack_crcs_arr = _pins_ops.compute(
      flat, sx, sy, sz, optimize_pins
    )
    labels_binary = _labels_ops.encode_condensed_pins(
      all_pins, sx, sy, sz,
      head.pin_index_width(), num_per_slice, n_total,
      stored_dtype, auto_bgcolor, manual_bgcolor,
    )
  else:
    labels_binary, crack_crcs_arr = _labels_ops.encode_flat(
      flat, sx, sy, sz, stored_dtype, parallel=parallel
    )

  return container(head, crack_code_bytes, labels_binary, crack_crcs_arr,
                   stored_model)


def compressa(*args, **kwargs):
  """compress, returning a CrackleArray."""
  from .array import CrackleArray
  return CrackleArray(compress(*args, **kwargs),
                      parallel=kwargs.get("parallel", 0))


# ---------------------------------------------------------------------------
# Reencode (markov order change) & stream maintenance
# ---------------------------------------------------------------------------

def reencode(binary: bytes, markov_model_order: int,
             parallel: int = 0) -> bytes:
  """Change the markov order of an existing stream without touching
  the labels section (reencode_with_markov_order parity)."""
  head = header(binary)
  if head.markov_model_order == markov_model_order:
    return binary

  model = decode_markov_model(head, binary)
  codes = crack_codes(binary)

  chains_per_z = []
  for code in codes:
    if len(code) == 0:
      chains_per_z.append({})
      continue
    index_size = 4 + ctoi(code, 0, 4)
    nodes = _cc.read_boc_index(code, head.sx, head.sy)
    if model is None:
      cps = _cc.unpack_codepoints(code, index_size)
    else:
      cps = _markov.decode_markov(
        code[index_size:], model, head.markov_model_order
      )
    sym_chains = _cc.codepoints_to_symbol_chains(cps, nodes)
    chains_per_z.append(_cc.symbols_to_codepoints(
      [(n, bytearray(s)) for n, s in sym_chains]
    ))

  head.markov_model_order = markov_model_order
  if markov_model_order > 0 and all(len(c) == 0 for c in chains_per_z):
    head.markov_model_order = 0

  stored_model = b''
  if head.markov_model_order > 0:
    diff_streams = []
    for chains in chains_per_z:
      _, cps = _cc.concat_chain_codepoints(chains)
      diff_streams.append(_cc.difference_code(cps))
    stats = _markov.gather_statistics(diff_streams, head.markov_model_order)
    new_model = _markov.stats_to_model(stats)
    stored_model = _markov.to_stored_model(new_model)
    crack_code_bytes = [
      _markov.compress_slice(chains, new_model, head.markov_model_order,
                             head.sx, head.sy)
      for chains in chains_per_z
    ]
  else:
    crack_code_bytes = [
      _cc.pack_codepoints(chains, head.sx, head.sy)
      for chains in chains_per_z
    ]

  z_index = np.array(
    [len(c) for c in crack_code_bytes], dtype='<u4'
  ).tobytes()
  z_index += itoc(crc32c(z_index), 4)

  lb = bytes(raw_labels(binary))
  stored_labels_crc = labels_crc(binary)
  stored_crack_crcs = crack_crcs(binary)

  return b''.join([
    head.tobytes(),
    z_index,
    lb,
    stored_model,
    *crack_code_bytes,
    itoc(stored_labels_crc, 4),
    stored_crack_crcs.tobytes(),
  ])


def condense_unique(binary: bytes) -> bytes:
  """Deduplicate + sort the unique table of a (possibly remapped)
  flat stream; sets is_sorted."""
  head = header(binary)
  uniq = labels(binary)
  reduced = np.unique(uniq)
  if len(uniq) == len(reduced) and np.all(uniq == reduced):
    return binary

  keys = extract_keys(binary)
  new_keys = np.searchsorted(reduced, uniq[keys])

  label_components = decode_flat_labels(head, binary)

  head.stored_data_width = compute_byte_width(int(reduced[-1]))
  key_width = compute_byte_width(len(reduced))

  labels_binary = b''.join([
    itoc(len(reduced), 8),
    reduced.astype(head.stored_dtype, copy=False).tobytes(),
    label_components["components_per_grid"].tobytes(),
    new_keys.astype(f'u{key_width}').tobytes(),
  ])

  comps = components(binary)
  head.num_label_bytes = len(labels_binary)
  head.is_sorted = True
  crack_crcs_binary = comps["crcs"][4:]

  return b''.join([
    head.tobytes(),
    comps["z_index"].tobytes(),
    labels_binary,
    comps["crack_codes"].tobytes(),
    itoc(crc32c(labels_binary), 4),
    crack_crcs_binary,
  ])


# ---------------------------------------------------------------------------
# Integrity checks
# ---------------------------------------------------------------------------

def check(binary: bytes) -> dict:
  """Test for file corruption, reporting which sections are damaged."""
  sections = {
    "header": None, "crack_index": None, "labels": None, "z": None,
  }
  try:
    head = CrackleHeader.frombytes(binary)
  except FormatError:
    sections["header"] = False
    return sections
  sections["header"] = True

  try:
    idx = grid_index(binary)
  except FormatError:
    sections["crack_index"] = False
    return sections
  if idx[-1] > len(binary):
    sections["crack_index"] = False
    return sections
  sections["crack_index"] = True

  if head.format_version == 0:
    return sections

  sections["labels"] = labels_crc(binary) == crc32c(bytes(raw_labels(binary)))

  sections["z"] = []
  for z in range(head.sz):
    try:
      decompress_range(binary, z, z + 1, 0)
    except (FormatError, RuntimeError, ValueError, IndexError):
      sections["z"].append(z)
  return sections


def ok(binary: bytes) -> bool:
  """Whole-file corruption check."""
  report = check(binary)
  if report["header"] is False:
    return False
  if report["crack_index"] is False:
    return False
  if report["labels"] is False:
    return False
  if report["z"] is not None and len(report["z"]) > 0:
    return False
  return True
