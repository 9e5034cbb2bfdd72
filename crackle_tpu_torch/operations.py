"""Stream surgery on .ckl binaries, the port's copy of
crackle_tpu/operations.py: metadata-only edits (remap, mask, astype,
refit, renumber), the z-axis splice (zstack, zsplit, zshatter),
synthesized streams (full, zeros, ones), scalar operators on the
unique table, and the decode-lite wrappers.

The edits are host byte surgery, as in the reference. What decodes goes
through the port's codec, so set_engine sends it to the card:
recompress, array_equal and mode_pooling_2x2x1 decode and encode there
under a torch engine, and voxel_connectivity_graph, contacts and
structure_equal take ops/analytics.py's device routes.
"""
import builtins
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import codec
from .codec import (
  background_color, compress, components, condense_unique, crack_codes,
  crack_crcs, decode_condensed_pins, decode_condensed_pins_components,
  decode_flat_labels, decompress_range, header, labels, labels_crc,
  num_labels, raw_labels, reencode,
)
from .headers import CrackFormat, CrackleHeader, FormatError, LabelFormat
from .lib import compute_byte_width, crc32c, fit_dtype, itoc, width2dtype

_min = builtins.min
_max = builtins.max


def min(binary: bytes) -> int:
  """Minimum label, O(1) for sorted streams."""
  head = header(binary)
  if not head.is_sorted:
    return int(np.min(labels(binary)))
  off = head.header_bytes + head.grid_index_bytes
  if head.label_format == LabelFormat.FLAT:
    return int.from_bytes(
      binary[off + 8:off + 8 + head.stored_data_width], 'little'
    )
  bg = background_color(binary)
  sdw = head.stored_data_width
  off += sdw + 8
  arrmin = int.from_bytes(binary[off:off + sdw], 'little')
  return bg if bg < arrmin else arrmin


def max(binary: bytes) -> int:
  """Maximum label, O(1) for sorted streams."""
  head = header(binary)
  if not head.is_sorted:
    return int(np.max(labels(binary)))
  loff = head.header_bytes + head.grid_index_bytes
  if head.label_format == LabelFormat.FLAT:
    N = num_labels(binary)
    off = loff + 8 + (N - 1) * head.stored_data_width
    return int.from_bytes(binary[off:off + head.stored_data_width], 'little')
  bg = background_color(binary)
  sdw = head.stored_data_width
  N = num_labels(binary) - 1
  off = loff + sdw + 8 + (N - 1) * sdw
  arrmax = int.from_bytes(binary[off:off + sdw], 'little')
  return bg if bg > arrmax else arrmax


def remap(binary: bytes, mapping: dict,
          preserve_missing_labels: bool = False, in_place: bool = False,
          parallel: int = 0) -> bytes:
  """Remap labels without decompressing: a pure dictionary edit of the
  unique table (crackle.hpp:1000-1130 parity), with a pure-host
  widening resynthesis when the new values outgrow the stored width."""
  head = header(binary)
  dtype = head.dtype
  if head.data_width < 8 and mapping:
    maxval = _max(mapping.values())
    dtype = fit_dtype(head.dtype, maxval)

  if np.dtype(dtype).itemsize <= head.stored_data_width:
    return _remap_in_place(binary, mapping, preserve_missing_labels,
                           in_place)

  # widening path: resynthesize the labels section
  label_components = decode_flat_labels(head, binary)
  uniq = label_components["unique"].copy()
  uniq = _apply_mapping(uniq, mapping, preserve_missing_labels)
  data_width = np.dtype(uniq.dtype).itemsize
  if data_width > head.data_width:
    head.data_width = data_width
  head.stored_data_width = data_width
  head.is_sorted = bool(np.all(uniq[:-1] <= uniq[1:])) if len(uniq) else True

  labels_binary = b''.join([
    itoc(len(uniq), 8),
    uniq.astype(head.stored_dtype, copy=False).tobytes(),
    label_components["components_per_grid"].tobytes(),
    label_components["cc_map"].tobytes(),
  ])
  head.num_label_bytes = len(labels_binary)

  comps = components(binary)
  crack_crcs_binary = comps["crcs"][4:]
  return b''.join([
    head.tobytes(),
    comps["z_index"].tobytes(),
    labels_binary,
    comps["crack_codes"].tobytes(),
    itoc(crc32c(labels_binary), 4),
    crack_crcs_binary,
  ])


def _apply_mapping(uniq: np.ndarray, mapping: dict,
                   preserve_missing_labels: bool) -> np.ndarray:
  maxval = int(uniq.max()) if len(uniq) else 0
  if mapping:
    maxval = _max(maxval, _max(mapping.values()))
  out_dtype = fit_dtype(np.uint64, maxval)
  out = uniq.astype(out_dtype)
  if not mapping:
    if not preserve_missing_labels and len(uniq):
      raise KeyError("mapping must be at least size 1.")
    return out
  keys = np.fromiter(mapping.keys(), dtype=np.uint64, count=len(mapping))
  vals = np.fromiter(
    (mapping[int(k)] for k in keys), dtype=out_dtype, count=len(mapping)
  )
  order = np.argsort(keys)
  keys, vals = keys[order], vals[order]
  idx = np.searchsorted(keys, out.astype(np.uint64))
  idx = np.clip(idx, 0, len(keys) - 1)
  hit = keys[idx] == out.astype(np.uint64)
  if not preserve_missing_labels and not hit.all():
    missing = out[~hit][0]
    raise KeyError(f"Label was missing: {missing}")
  out[hit] = vals[idx[hit]]
  return out


def _remap_in_place(binary: bytes, mapping: dict,
                    preserve_missing_labels: bool,
                    in_place: bool) -> bytes:
  head = header(binary)
  lb = bytes(raw_labels(binary))
  if head.format_version > 0:
    if crc32c(lb) != labels_crc(binary):
      raise FormatError("crackle::remap: crc mismatch on labels binary.")

  from .ops import labels as _labels_ops
  uniq = _labels_ops.decode_uniq(head, lb).copy()
  target_size = len(uniq) + (
    head.label_format == LabelFormat.PINS_VARIABLE_WIDTH
  )
  if not preserve_missing_labels and len(mapping) == 0 and target_size > 0:
    raise ValueError("mapping must be at least size 1.")

  new_uniq = _apply_mapping(uniq, mapping, preserve_missing_labels)
  new_uniq = new_uniq.astype(head.stored_dtype)
  head.is_sorted = (
    bool(np.all(new_uniq[:-1] <= new_uniq[1:])) if len(new_uniq) else True
  )

  out = bytearray(binary)
  uoff = head.header_bytes + head.grid_index_bytes
  if head.label_format == LabelFormat.PINS_VARIABLE_WIDTH:
    bg = background_color(binary)
    if bg in mapping:
      out[uoff:uoff + head.stored_data_width] = \
        itoc(mapping[bg], head.stored_data_width)
    uoff += head.stored_data_width
  uoff += 8
  out[uoff:uoff + new_uniq.nbytes] = new_uniq.tobytes()

  out[:head.header_bytes] = head.tobytes()
  if head.format_version > 0:
    new_lb = bytes(out[
      head.header_bytes + head.grid_index_bytes:
      head.header_bytes + head.grid_index_bytes + head.num_label_bytes
    ])
    crc_off = len(out) - (head.sz + 1) * 4
    out[crc_off:crc_off + 4] = itoc(crc32c(new_lb), 4)
  return bytes(out)


def mask(binary: bytes, labels: list, value: int = 0,
         in_place: bool = False, parallel: int = 0) -> bytes:
  """Mask the indicated labels with value."""
  masked = remap(
    binary, {int(lbl): int(value) for lbl in labels},
    preserve_missing_labels=True, in_place=in_place, parallel=parallel,
  )
  return condense_unique(masked)


def mask_except(binary: bytes, labels: list, value: int = 0,
                in_place: bool = False, parallel: int = 0) -> bytes:
  """Mask all labels except the indicated ones with value."""
  all_labels = codec.labels(binary)
  keep = set(int(l) for l in labels)
  mapping = {
    int(segid): (int(value) if int(segid) not in keep else int(segid))
    for segid in all_labels
  }
  masked = remap(binary, mapping, in_place=in_place, parallel=parallel)
  return condense_unique(masked)


def astype(binary: bytes, dtype, order: str = 'K',
           casting: str = "unsafe") -> bytes:
  """Change the rendered dtype (header-only edit)."""
  head = header(binary)
  dtype = np.dtype(dtype)
  if np.issubdtype(dtype, np.signedinteger):
    raise TypeError("Signed integer data types are not currently supported.")
  if casting in ("no", "equiv"):
    if dtype != head.dtype:
      raise TypeError(
        f"Cannot cast dtype {head.dtype} to {dtype} under casting type 'no'"
      )
  elif casting == "same_kind":
    if np.issubdtype(head.dtype, np.unsignedinteger):
      if not np.issubdtype(dtype, np.unsignedinteger):
        raise TypeError(
          f"Cannot cast {head.dtype} to {dtype} under 'same_kind'"
        )
    elif not np.issubdtype(dtype, np.signedinteger):
      raise TypeError(
        f"Cannot cast {head.dtype} to {dtype} under 'same_kind'"
      )
  elif casting == "safe":
    maxval = max(binary)
    if maxval > np.iinfo(dtype).max:
      raise TypeError(
        f"Specified dtype {dtype} causes truncation of max value "
        f"{maxval} under casting type 'safe'"
      )
    minval = min(binary)
    if minval < np.iinfo(dtype).min:
      raise TypeError(
        f"Specified dtype {dtype} causes truncation of min value "
        f"{minval} under casting type 'safe'"
      )
  head.signed = np.issubdtype(dtype, np.signedinteger)
  head.data_width = dtype.itemsize
  if order == 'C':
    head.fortran_order = False
  elif order == 'F':
    head.fortran_order = True
  return head.tobytes() + binary[head.header_bytes:]


def refit(binary: bytes) -> bytes:
  """Shrink the rendered dtype to the smallest lossless one."""
  head = header(binary)
  dtype = fit_dtype(head.dtype, max(binary))
  return astype(binary, dtype)


def renumber(binary: bytes, start: int = 0,
             parallel: int = 0) -> Tuple[bytes, dict]:
  """Renumber labels densely from start; refit dtype."""
  head = header(binary)
  uniq = np.unique(labels(binary))
  mapping = {int(u): start + i for i, u in enumerate(uniq)}
  binary = refit(remap(binary, mapping, parallel=parallel))
  if not head.is_sorted:
    head2 = header(binary)
    head2.is_sorted = True
    binary = head2.tobytes() + binary[head2.header_bytes:]
  return (binary, mapping)


# ---------------------------------------------------------------------------
# zstack / zsplit
# ---------------------------------------------------------------------------

def _zstack_flat_labels(uniq: np.ndarray, binaries: List[bytes]) -> bytes:
  """Merged flat-labels section for a stack: one global sorted
  dictionary and every part's component keys re-pointed into it
  (layout per SURVEY §2.4 / labels.hpp:126-153)."""
  sdtype = width2dtype[compute_byte_width(int(uniq[-1]))]
  kdtype = width2dtype[compute_byte_width(len(uniq))]

  grid_counts = []
  global_keys = []
  for part in binaries:
    sec = decode_flat_labels(header(part), part)
    grid_counts.append(sec["components_per_grid"])
    # local key -> local label -> global key, fused into one gather
    into_global = np.searchsorted(uniq, sec["unique"]).astype(kdtype)
    global_keys.append(into_global[sec["cc_map"]])

  return b"".join(
    [itoc(len(uniq), 8), uniq.astype(sdtype, copy=False).tobytes()]
    + [g.tobytes() for g in grid_counts]
    + [k.tobytes() for k in global_keys]
  )


def _zstack_pins(uniq: np.ndarray, binaries: List[bytes]) -> bytes:
  """Merged condensed-pins section: every part's pins shift into the
  stacked volume's voxel index space and its cc-singles into the
  running global component numbering, then each label's rows re-emit
  diff-coded at the stack-wide widths (layout per SURVEY §2.4 /
  labels.hpp:261-343)."""
  head0 = header(binaries[0])
  bg = background_color(binaries[0])
  sxy = head0.sx * head0.sy

  # gather columns per label, rebased into stack-global coordinates
  pins_of = defaultdict(list)    # label -> [(index, depth) i64 rows]
  singles_of = defaultdict(list)  # label -> [global cc ids]
  grid_counts = []
  voxel_base = 0
  comp_base = 0
  for part in binaries:
    if background_color(part) != bg:
      raise ValueError(
        f"pin stacks share one background color; "
        f"got {bg} and {background_color(part)}"
      )
    part_pins, part_singles = decode_condensed_pins(part)
    for label, rows in part_pins.items():
      if rows:
        arr = np.asarray(rows, dtype=np.int64).reshape(-1, 2)
        arr[:, 0] += voxel_base
        pins_of[label].append(arr)
    for label, ccids in part_singles.items():
      if len(ccids):
        singles_of[label].append(
          np.asarray(ccids, dtype=np.int64) + comp_base)
    counts = decode_condensed_pins_components(part)[
      "components_per_grid"]
    grid_counts.append(counts)
    comp_base += int(counts.sum())
    voxel_base += header(part).sz * sxy

  # stack-wide field widths
  most_pins = _max((sum(len(a) for a in v) for v in pins_of.values()),
                   default=0)
  deepest = _max((int(a[:, 1].max()) for v in pins_of.values()
                  for a in v), default=0)
  top_cc = _max((int(a.max()) for v in singles_of.values()
                 for a in v), default=0)
  count_w = compute_byte_width(most_pins)
  depth_w = compute_byte_width(deepest)
  cc_w = compute_byte_width(top_cc)
  layout_byte = (count_w.bit_length() - 1) \
      | ((depth_w.bit_length() - 1) << 2) \
      | ((cc_w.bit_length() - 1) << 4)
  index_w = head0.pin_index_width()

  def delta_bytes(sorted_vals: np.ndarray, width: int) -> bytes:
    d = np.diff(sorted_vals, prepend=np.int64(0))
    return d.astype(f"u{width}").tobytes()

  foreground = uniq[uniq != bg]
  sections = []
  for label in foreground:
    rows = pins_of.get(label)
    if rows:
      merged = np.concatenate(rows)
      merged = merged[np.argsort(merged[:, 0], kind="stable")]
    else:
      merged = np.zeros((0, 2), dtype=np.int64)
    ccids = singles_of.get(label)
    ccids = np.sort(np.concatenate(ccids)) if ccids \
        else np.zeros(0, dtype=np.int64)
    sections.append(b"".join([
      itoc(len(merged), count_w),
      delta_bytes(merged[:, 0], index_w),
      merged[:, 1].astype(f"u{depth_w}").tobytes(),
      itoc(len(ccids), count_w),
      delta_bytes(ccids, cc_w),
    ]))

  sdtype = width2dtype[compute_byte_width(int(uniq[-1]))]
  return b"".join([
    itoc(int(bg), head0.stored_data_width),
    itoc(len(foreground), 8),
    foreground.astype(sdtype, copy=False).tobytes(),
    *[g.tobytes() for g in grid_counts],
    itoc(layout_byte, 1),
    *sections,
  ])


def _check_stackable(ref: CrackleHeader, head: CrackleHeader):
  mismatches = [
    (ref.sx != head.sx or ref.sy != head.sy,
     f"every part needs the same slice shape; expected "
     f"{ref.sx}x{ref.sy}, got {head.sx}x{head.sy}"),
    (ref.label_format != head.label_format,
     f"label formats differ: {ref.label_format} vs "
     f"{head.label_format}"),
    (ref.grid_size != head.grid_size, "grid sizes differ"),
    (ref.crack_format != head.crack_format, "crack formats differ"),
    (ref.signed != head.signed, "signedness differs"),
  ]
  for bad, msg in mismatches:
    if bad:
      raise ValueError(f"zstack: {msg}")


def zstack(images: Sequence) -> bytes:
  """Stack numpy arrays, CrackleArrays and .ckl binaries along z into one
  stream without decompressing pixel data: crack codes splice
  byte-for-byte with their crcs carried over; only the label dictionary
  merges."""
  from .array import CrackleArray

  parts: List[bytes] = []
  ref = None
  for img in images:
    if img is None:
      continue
    if isinstance(img, np.ndarray):
      binary = compress(img)
    else:
      raw = img.binary if isinstance(img, CrackleArray) else img
      # markov bitstreams are model-specific; normalize so the spliced
      # crack sections share one (absent) model
      binary = reencode(raw, markov_model_order=0)
    head = header(binary)
    if ref is None:
      ref = head
    _check_stackable(ref, head)
    binary = asfortranarray(binary) if ref.fortran_order \
        else ascontiguousarray(binary)
    parts.append(binary)

  if len(parts) == 1:
    return parts[0]

  uniq = np.unique(np.concatenate([
    labels(p).astype(np.uint64) for p in parts
  ]))

  out_head = header(parts[0])
  out_head.sz = sum(header(p).sz for p in parts)
  out_head.data_width = _max(header(p).data_width for p in parts)
  out_head.stored_data_width = compute_byte_width(int(uniq[-1]))

  if out_head.label_format == LabelFormat.FLAT:
    label_section = _zstack_flat_labels(uniq, parts)
  elif out_head.label_format == LabelFormat.PINS_VARIABLE_WIDTH:
    label_section = _zstack_pins(uniq, parts)
  else:
    raise ValueError(
      f"Unsupported label format: {out_head.label_format}")
  out_head.num_label_bytes = len(label_section)

  per_part_codes = [crack_codes(p) for p in parts]
  slice_lengths = np.array(
    [len(c) for codes in per_part_codes for c in codes],
    dtype=np.uint32)
  z_index = slice_lengths.tobytes()
  crack_payload = b"".join(
    c for codes in per_part_codes for c in codes)

  checked = out_head.format_version > 0
  return b"".join([
    out_head.tobytes(),
    z_index,
    itoc(crc32c(z_index), 4) if checked else b"",
    label_section,
    crack_payload,
    itoc(crc32c(label_section), 4) if checked else b"",
    np.concatenate([crack_crcs(p) for p in parts]).tobytes()
    if checked else b"",
  ])


def _zsplit_helper(binary: bytes):
  head = header(binary)
  if head.label_format != LabelFormat.FLAT:
    raise ValueError("Label format not currently supported.")

  uniq = labels(binary)
  raw = bytes(raw_labels(binary))
  N = num_labels(binary)
  idx_bytes = head.component_width() * head.sz
  offset = 8 + N * head.stored_data_width
  label_idx = np.frombuffer(
    raw[offset:offset + idx_bytes], dtype=f"u{head.component_width()}"
  )
  offset += idx_bytes
  key_width = compute_byte_width(N)
  keys = np.frombuffer(raw[offset:], dtype=f'u{key_width}')

  label_idx_offsets = np.concatenate([[0], np.cumsum(label_idx)])
  all_zindex = np.frombuffer(
    components(binary)["z_index"].tobytes()[:head.sz * 4], dtype=np.uint32
  )
  cracks = crack_codes(binary)
  all_crack_crcs = crack_crcs(binary)

  def synth(head, zindex, local_label_idx, sub_keys, sub_cracks,
            sub_crack_crcs):
    head = CrackleHeader.frombytes(binary)  # fresh copy per call
    local_uniq = np.unique(uniq[sub_keys]) if len(sub_keys) else \
        np.unique(uniq[:0])
    remapped_keys = np.searchsorted(local_uniq, uniq[sub_keys])
    key_width = compute_byte_width(len(local_uniq))
    head.stored_data_width = compute_byte_width(
      int(local_uniq.max()) if len(local_uniq) else 0
    )

    labels_binary = b''.join([
      itoc(len(local_uniq), 8),
      local_uniq.astype(head.stored_dtype).tobytes(),
      local_label_idx.tobytes(),
      remapped_keys.astype(f'u{key_width}').tobytes(),
    ])

    head.sz = len(sub_cracks)
    head.num_label_bytes = len(labels_binary)

    gi = zindex.tobytes()
    labels_crc_b = b''
    crack_crcs_b = b''
    if head.format_version > 0:
      gi += itoc(crc32c(gi), 4)
      labels_crc_b = itoc(crc32c(labels_binary), 4)
      crack_crcs_b = np.asarray(sub_crack_crcs, dtype=np.uint32).tobytes()

    return b''.join([
      head.tobytes(), gi, labels_binary, *sub_cracks,
      labels_crc_b, crack_crcs_b,
    ])

  def synth_z_range(z_start: int, z_end: int) -> bytes:
    sub_crcs = []
    if head.format_version > 0:
      sub_crcs = all_crack_crcs[z_start:z_end]
    return synth(
      head,
      all_zindex[z_start:z_end],
      label_idx[z_start:z_end],
      keys[int(label_idx_offsets[z_start]):int(label_idx_offsets[z_end])],
      cracks[z_start:z_end],
      sub_crcs,
    )

  return synth_z_range


def zsplit(binary: bytes, z: int) -> Tuple[bytes, bytes, bytes]:
  """Split a stream at z into (before, middle slice, after)."""
  head = header(binary)
  if z < 0 or z >= head.sz:
    raise ValueError(f"{z} is outside the range 0 to {head.sz}.")
  if head.sz == 1 and z == 0:
    return (b'', binary, b'')
  crt = _zsplit_helper(binary)
  return (crt(0, z), crt(z, z + 1), crt(z + 1, head.sz))


def zshatter(binary: bytes) -> List[bytes]:
  """Split a stream into single z-slice streams."""
  head = header(binary)
  crt = _zsplit_helper(binary)
  return [crt(z, z + 1) for z in range(head.sz)]


def asfortranarray(binary: bytes) -> bytes:
  """Flip the stream to Fortran order (header-only edit)."""
  head = header(binary)
  if head.fortran_order:
    return binary
  head.fortran_order = True
  return head.tobytes() + binary[head.header_bytes:]


def ascontiguousarray(binary: bytes) -> bytes:
  """Flip the stream to C order (header-only edit)."""
  head = header(binary)
  if not head.fortran_order:
    return binary
  head.fortran_order = False
  return head.tobytes() + binary[head.header_bytes:]


# ---------------------------------------------------------------------------
# Synthesized streams
# ---------------------------------------------------------------------------

EMPTY_SLICE_CRACK_CODE = b'\x01\x00\x00\x00\x00'


def full(shape, fill_value, dtype=None, order='C') -> bytes:
  """Synthesize a constant-filled stream without compression
  (operations.py:690-741 parity, byte-identical construction)."""
  if dtype is None:
    dtype = np.array(fill_value).dtype

  head = CrackleHeader(
    label_format=LabelFormat.FLAT,
    crack_format=CrackFormat.IMPERMISSIBLE,
    data_width=np.dtype(dtype).itemsize,
    stored_data_width=compute_byte_width(fill_value),
    sx=shape[0], sy=shape[1], sz=shape[2],
    num_label_bytes=0,
    fortran_order=(order == 'F'),
    grid_size=int(2 ** 31),
    signed=(fill_value < 0),
    markov_model_order=0,
    is_sorted=True,
  )

  labels_binary = b''.join([
    itoc(1, 8),
    np.array([fill_value], dtype=head.stored_dtype).tobytes(),
    np.ones([head.sz], dtype=f'u{head.component_width()}').tobytes(),
    np.zeros([head.sz], dtype=np.uint8).tobytes(),
  ])
  head.num_label_bytes = len(labels_binary)
  head.is_sorted = True

  gi = np.full(
    [head.sz], len(EMPTY_SLICE_CRACK_CODE), dtype=np.uint32
  ).tobytes()
  gi += itoc(crc32c(gi), 4)

  labels_crc_binary = itoc(crc32c(labels_binary), 4)
  crack_crc_single = crc32c(np.zeros(shape[0] * shape[1], dtype='<u4'))
  crack_crcs_binary = np.full(
    [shape[2]], crack_crc_single, dtype=np.uint32
  ).tobytes()

  return b''.join([
    head.tobytes(),
    gi,
    labels_binary,
    EMPTY_SLICE_CRACK_CODE * head.sz,
    labels_crc_binary,
    crack_crcs_binary,
  ])


def zeros(shape, dtype=None, order="C") -> bytes:
  return full(shape, 0, dtype, order)


def ones(shape, dtype=None, order="C") -> bytes:
  return full(shape, 1, dtype, order)


# ---------------------------------------------------------------------------
# Scalar operators on the unique table
# ---------------------------------------------------------------------------

def operator(binary: bytes, fn) -> bytes:
  head = header(binary)
  parts = decode_flat_labels(head, binary)
  parts["unique"] = fn(parts["unique"])
  head.stored_data_width = compute_byte_width(int(parts["unique"][-1]))

  labels_binary = b''.join([
    itoc(len(parts["unique"]), 8),
    parts["unique"].astype(head.stored_dtype, copy=False).tobytes(),
    parts["components_per_grid"].tobytes(),
    parts["cc_map"].tobytes(),
  ])
  full_parts = components(binary)
  head.num_label_bytes = len(labels_binary)

  labels_crc_binary = b''
  crack_crcs_binary = b''
  if head.format_version > 0:
    labels_crc_binary = itoc(crc32c(labels_binary), 4)
    crack_crcs_binary = crack_crcs(binary).tobytes()

  return b''.join([
    head.tobytes(),
    full_parts["z_index"].tobytes(),
    labels_binary,
    full_parts["crack_codes"].tobytes(),
    labels_crc_binary,
    crack_crcs_binary,
  ])


def add_scalar(binary: bytes, scalar: int) -> bytes:
  if scalar == 0:
    return binary
  return operator(binary, lambda uniq: uniq + scalar)


def subtract_scalar(binary: bytes, scalar: int) -> bytes:
  if scalar == 0:
    return binary
  return operator(binary, lambda uniq: uniq - scalar)


def multiply_scalar(binary: bytes, scalar: int) -> bytes:
  if scalar == 1:
    return binary
  return operator(binary, lambda uniq: uniq * scalar)


def floordiv_scalar(binary: bytes, scalar: int) -> bytes:
  if scalar == 1:
    return binary
  return operator(binary, lambda uniq: uniq // scalar)


def truediv_scalar(binary: bytes, scalar: int) -> bytes:
  if scalar == 1:
    return binary
  return operator(binary, lambda uniq: uniq / scalar)


# ---------------------------------------------------------------------------
# Recompression & 3D ops
# ---------------------------------------------------------------------------

def recompress(binary: bytes, memory_target: int = int(4e9),
               allow_pins: bool = False) -> bytes:
  """Decode + re-encode in z-chunks to drop false boundaries after
  remapping, bounded by a memory target."""
  import multiprocessing as mp
  head = header(binary)
  section_bytes = head.sx * head.sy * (head.data_width + 4 + 1)
  parallel = _max(memory_target - len(binary), 0) // _max(section_bytes, 1)
  parallel = _max(parallel, 1)
  parallel = _min(parallel, mp.cpu_count())

  bgcolor = min(binary)
  binaries = []
  for z in range(0, head.sz, parallel):
    z_end = _min(z + parallel, head.sz)
    arr = decompress_range(binary, z_start=z, z_end=z_end, parallel=parallel)
    binaries.append(compress(arr, allow_pins=allow_pins, bgcolor=bgcolor))
  return zstack(binaries)


def connected_components(binary: bytes, connectivity: int = 26,
                         binary_image: bool = False,
                         memory_target: int = int(100e6),
                         progress: bool = False,
                         return_mapping: bool = False):
  """3D connected component labeling of the stream, returned as a new
  stream. Uses a z-chunked union-find merge so the full volume is
  never decompressed at once."""
  from .ops.analytics import connected_components_3d
  return connected_components_3d(
    binary, connectivity=connectivity, binary_image=binary_image,
    memory_target=memory_target, progress=progress,
    return_mapping=return_mapping,
  )


def voxel_connectivity_graph(binary: bytes, connectivity: int = 6,
                             parallel: int = 0) -> np.ndarray:
  """Voxel connectivity graph as uint8: bits 00-z+z-y+y-x+x (LSB
  right)."""
  from .ops.analytics import voxel_connectivity_graph as _vcg
  return _vcg(binary, connectivity=connectivity, parallel=parallel)


def contacts(binary: bytes,
             anisotropy: Tuple[float, float, float] = (1.0, 1.0, 1.0)
             ) -> Dict[Tuple[int, int], float]:
  """6-connected contact surface areas between labels."""
  from .ops.analytics import contacts as _contacts
  return _contacts(binary, anisotropy=anisotropy)


def array_equal(binary1: bytes, binary2: bytes, parallel: int = 0) -> bool:
  """Content equality regardless of encoding representation."""
  h1 = header(binary1)
  h2 = header(binary2)
  if h1.sx != h2.sx or h1.sy != h2.sy or h1.sz != h2.sz:
    return False
  if num_labels(binary1) != num_labels(binary2):
    return False
  uniq1 = labels(binary1)
  uniq2 = labels(binary2)
  if len(uniq1) != len(uniq2) or np.any(uniq1 != uniq2):
    return False
  for z in range(h1.sz):
    a = decompress_range(binary1, z, z + 1, 0)
    b = decompress_range(binary2, z, z + 1, 0)
    if not np.array_equal(a, b):
      return False
  return True


def structure_equal(binary1: bytes, binary2: bytes,
                    parallel: int = 0) -> bool:
  """Structural equality (same components) regardless of labels."""
  h1 = header(binary1)
  h2 = header(binary2)
  if h1.sx != h2.sx or h1.sy != h2.sy or h1.sz != h2.sz:
    return False
  if h1.format_version > 0 and h2.format_version > 0:
    if not np.all(crack_crcs(binary1) == crack_crcs(binary2)):
      return False
  vcg1 = voxel_connectivity_graph(binary1, connectivity=4, parallel=parallel)
  vcg2 = voxel_connectivity_graph(binary2, connectivity=4, parallel=parallel)
  return bool(np.all(vcg1 == vcg2))


def mode_pooling_2x2x1(binary: bytes, parallel: int = 0) -> bytes:
  """Downsample 2x2x1 by mode pooling; returns a new stream."""
  from .ops.analytics import mode_pooling_2x2x1 as _mp
  binaries = _mp(binary, parallel=parallel)
  return zstack(binaries)
