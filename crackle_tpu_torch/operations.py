"""Stream surgery on .ckl binaries: the z-axis splice.

The port's copy of the part of crackle_tpu/operations.py that
parallel.multihost needs: zstack, which splices streams along z without
decoding pixels (crack codes and their CRCs carried over byte for byte,
the label dictionary merged), and the header-only order flips it applies.
The port has no CrackleArray, so zstack takes bytes and numpy arrays.
"""
from collections import defaultdict
from typing import List, Sequence

import numpy as np

from .codec import (
  background_color, compress, crack_codes, crack_crcs,
  decode_condensed_pins, decode_condensed_pins_components,
  decode_flat_labels, header, labels, reencode,
)
from .headers import CrackleHeader, LabelFormat
from .lib import compute_byte_width, crc32c, itoc, width2dtype


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
  most_pins = max((sum(len(a) for a in v) for v in pins_of.values()),
                  default=0)
  deepest = max((int(a[:, 1].max()) for v in pins_of.values()
                 for a in v), default=0)
  top_cc = max((int(a.max()) for v in singles_of.values()
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
  """Stack numpy arrays and .ckl binaries along z into one stream
  without decompressing pixel data: crack codes splice byte-for-byte
  with their crcs carried over; only the label dictionary merges."""
  parts: List[bytes] = []
  ref = None
  for img in images:
    if img is None:
      continue
    if isinstance(img, np.ndarray):
      binary = compress(img)
    else:
      # markov bitstreams are model-specific; normalize so the spliced
      # crack sections share one (absent) model
      binary = reencode(img, markov_model_order=0)
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
  out_head.data_width = max(header(p).data_width for p in parts)
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
