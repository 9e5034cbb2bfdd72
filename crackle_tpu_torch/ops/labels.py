"""Label-map encodings: FLAT and condensed PINS.

Reference parity: src/labels.hpp.

FLAT layout:
  u64 N | uniq[N] x stored_width (sorted) | cc_per_grid[sz] x
  width(sx*sy) | keys[sum Nz] x width(N)
Keys index into uniq, concatenated in z order, one entry per 2D
connected component in per-slice first-visit order.

CONDENSED PINS layout:
  bgcolor x stored_width | u64 N | uniq[N] (bg excluded, sorted) |
  cc_per_grid[sz] | fmt u8 (00CCDDNN) | per label in uniq order:
  [num_pins | delta-index... | depth... | num_cc | delta-cc-id...]
"""
from typing import Dict, List, Tuple

import numpy as np

from ..lib import compute_byte_width, width2dtype, itoc, ctoi, crc32c
from .ccl import connected_components_slice


def encode_flat(labels: np.ndarray, sx: int, sy: int, sz: int,
                stored_dtype, parallel: int = 0
                ) -> Tuple[bytes, np.ndarray]:
  """FLAT label encode (labels.hpp:30-155 parity).

  labels: flat volume in x-fastest order. Slices run on a thread pool
  like the reference (labels.hpp:51-88); the native CCL and crc32c
  release the GIL.
  Returns (labels binary, per-slice crack crc32cs of the slice-local
  uint32 CCL images).
  """
  sxy = sx * sy
  stored_dtype = np.dtype(stored_dtype)

  per_slice_mapping: List[np.ndarray] = [None] * sz
  num_per_slice = np.zeros(sz, dtype=np.uint64)
  crcs = np.zeros(sz, dtype=np.uint32)

  def one(z):
    sl = labels[z * sxy:(z + 1) * sxy]
    cc, n = connected_components_slice(sl, sx, sy)
    # label of each component = source label at its first-visit voxel;
    # components are numbered by first visit, so their first
    # occurrences appear in increasing id order: a position is a first
    # visit iff its id exceeds the running max (O(n), no sort)
    if n:
      cci = cc.astype(np.int64)
      runmax = np.maximum.accumulate(np.concatenate([[-1], cci[:-1]]))
      first_idx = np.flatnonzero(cci > runmax)
      per_slice_mapping[z] = sl[first_idx]
    else:
      per_slice_mapping[z] = sl[:0]
    num_per_slice[z] = n
    crcs[z] = crc32c(np.ascontiguousarray(cc, dtype='<u4'))

  import os as _os
  n_threads = max(1, min(
    parallel if parallel > 0 else (_os.cpu_count() or 1), sz))
  if n_threads <= 1 or sz <= 1:
    for z in range(sz):
      one(z)
  else:
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(n_threads) as pool:
      list(pool.map(one, range(sz)))

  if sz:
    mapping = np.concatenate(per_slice_mapping)
  else:
    mapping = np.zeros(0, dtype=labels.dtype)

  uniq = np.unique(mapping)
  keys = np.searchsorted(uniq, mapping)

  key_width = compute_byte_width(len(uniq))
  component_width = compute_byte_width(sxy)

  binary = b''.join([
    itoc(len(uniq), 8),
    np.ascontiguousarray(uniq.astype(stored_dtype)).tobytes(),
    np.ascontiguousarray(
      num_per_slice.astype(width2dtype[component_width])
    ).tobytes(),
    np.ascontiguousarray(
      keys.astype(width2dtype[key_width])
    ).tobytes(),
  ])
  return binary, crcs


# ---------------------------------------------------------------------------
# FLAT decode
# ---------------------------------------------------------------------------

def decode_num_labels(header, labels_binary: bytes) -> int:
  from ..headers import LabelFormat
  if header.label_format == LabelFormat.FLAT:
    return ctoi(labels_binary, 0, 8)
  return ctoi(labels_binary, header.stored_data_width, 8)


def decode_uniq(header, labels_binary: bytes) -> np.ndarray:
  from ..headers import LabelFormat
  n = decode_num_labels(header, labels_binary)
  offset = 8 if header.label_format == LabelFormat.FLAT \
      else 8 + header.stored_data_width
  return np.frombuffer(
    labels_binary, dtype=header.stored_dtype, count=n, offset=offset
  )


def components_per_grid(header, labels_binary: bytes) -> np.ndarray:
  from ..headers import LabelFormat
  n = decode_num_labels(header, labels_binary)
  offset = 8 + n * header.stored_data_width
  if header.label_format != LabelFormat.FLAT:
    offset += header.stored_data_width
  cw = header.component_width()
  return np.frombuffer(
    labels_binary, dtype=width2dtype[cw], count=header.num_grids(),
    offset=offset,
  )


def decode_flat(header, labels_binary: bytes, z_start: int, z_end: int,
                out_dtype) -> np.ndarray:
  """Label map (component -> label value) for a z window
  (labels.hpp:453-506 parity)."""
  n = decode_num_labels(header, labels_binary)
  uniq = decode_uniq(header, labels_binary)
  cpg = components_per_grid(header, labels_binary)

  cc_label_width = compute_byte_width(n)
  cum = np.concatenate([[0], np.cumsum(cpg.astype(np.int64))])
  left = int(cum[z_start])
  count = int(cum[z_end] - cum[z_start])

  offset = (8 + n * header.stored_data_width
            + header.component_width() * header.num_grids()
            + left * cc_label_width)
  keys = np.frombuffer(
    labels_binary, dtype=width2dtype[cc_label_width],
    count=count, offset=offset,
  )
  if len(keys) and int(keys.max()) >= len(uniq):
    from ..headers import FormatError
    raise FormatError(
      "crackle: labels section is corrupted (key index out of range)."
    )
  return uniq[keys].astype(out_dtype, copy=False)


# ---------------------------------------------------------------------------
# Condensed pins encode/decode
# ---------------------------------------------------------------------------

def find_bgcolor(all_pins: Dict[int, list], sz: int) -> int:
  """Pick the background color: label with the most pins; ties by the
  largest total pin depth (labels.hpp:157-190 parity)."""
  bgcolor = 0
  max_pins = 0
  max_pins_depth = sz
  for label in all_pins:
    pins = all_pins[label]
    if len(pins) > max_pins:
      bgcolor = label
      max_pins = len(pins)
      max_pins_depth = sum(p.depth for p in pins)
    elif len(pins) == max_pins:
      depth = sum(p.depth for p in pins)
      if depth > max_pins_depth:
        bgcolor = label
        max_pins_depth = depth
  return bgcolor


def encode_condensed_pins(
  all_pins: Dict[int, list],
  sx: int, sy: int, sz: int,
  index_width: int,
  num_components_per_slice: np.ndarray,
  num_components: int,
  stored_dtype,
  auto_bgcolor: bool = True,
  manual_bgcolor: int = 0,
) -> bytes:
  """Serialize solved pins (labels.hpp:192-344 parity).

  all_pins: label -> list of CandidatePin (from ops.pins). Pins whose
  depth is below the cc-efficiency threshold are stored as sorted
  diff-coded global cc-id lists instead.
  """
  stored_dtype = np.dtype(stored_dtype)
  bgcolor = find_bgcolor(all_pins, sz) if auto_bgcolor else manual_bgcolor
  all_pins = {k: v for k, v in all_pins.items() if k != bgcolor}

  max_pins = 0
  max_depth = 0
  for pins in all_pins.values():
    max_pins = max(max_pins, len(pins))
    for p in pins:
      max_depth = max(max_depth, p.depth)

  all_labels = np.sort(
    np.array(list(all_pins.keys()), dtype=np.uint64)
  )

  num_pins_width = compute_byte_width(max_pins)
  depth_width = compute_byte_width(max_depth)
  cc_label_width = compute_byte_width(num_components)
  component_width = compute_byte_width(sx * sy)

  pin_bytes = index_width + depth_width
  cc_efficient_threshold = pin_bytes // cc_label_width

  combined_width = (
    int(np.log2(num_pins_width))
    | (int(np.log2(depth_width)) << 2)
    | (int(np.log2(cc_label_width)) << 4)
  )

  parts = [
    itoc(int(bgcolor), stored_dtype.itemsize),
    itoc(len(all_labels), 8),
    np.ascontiguousarray(all_labels.astype(stored_dtype)).tobytes(),
    np.ascontiguousarray(
      np.asarray(num_components_per_slice)
      .astype(width2dtype[component_width])
    ).tobytes(),
    itoc(combined_width, 1),
  ]

  for label in all_labels:
    pins = sorted(all_pins[int(label)], key=lambda p: p.start_idx(sx, sy))

    pin_repr = [p for p in pins if p.depth >= cc_efficient_threshold]
    cc_repr = [p for p in pins if p.depth < cc_efficient_threshold]

    pin_index = np.array(
      [p.start_idx(sx, sy) for p in pin_repr], dtype=np.int64
    )
    if len(pin_index) > 1:
      pin_index[1:] = np.diff(pin_index)

    parts.append(itoc(len(pin_repr), num_pins_width))
    for v in pin_index:
      parts.append(itoc(int(v), index_width))
    for p in pin_repr:
      parts.append(itoc(int(p.depth), depth_width))

    cc_ids = np.sort(np.concatenate(
      [np.asarray(p.ccids, dtype=np.int64) for p in cc_repr]
      or [np.zeros(0, dtype=np.int64)]
    ))
    diffs = cc_ids.copy()
    if len(diffs) > 1:
      diffs[1:] = np.diff(cc_ids)

    parts.append(itoc(len(cc_ids), num_pins_width))
    for v in diffs:
      parts.append(itoc(int(v), cc_label_width))

  return b''.join(parts)


def decode_condensed_pins_layout(header, labels_binary: bytes):
  """Parse the fixed-layout part of a pins section. Returns dict with
  bgcolor, uniq, components_per_grid, widths and the pinset byte
  offset."""
  sdw = header.stored_data_width
  bgcolor = ctoi(labels_binary, 0, sdw)
  num_labels = ctoi(labels_binary, sdw, 8)
  offset = sdw + 8
  uniq = np.frombuffer(
    labels_binary, dtype=header.stored_dtype, count=num_labels,
    offset=offset,
  )
  offset += num_labels * sdw
  cw = header.component_width()
  cpg = np.frombuffer(
    labels_binary, dtype=width2dtype[cw], count=header.num_grids(),
    offset=offset,
  )
  offset += cw * header.num_grids()
  combined_width = labels_binary[offset]
  offset += 1
  return {
    "bgcolor": bgcolor,
    "uniq": uniq,
    "components_per_grid": cpg,
    "num_pins_width": 2 ** (combined_width & 0b11),
    "depth_width": 2 ** ((combined_width >> 2) & 0b11),
    "cc_label_width": 2 ** ((combined_width >> 4) & 0b11),
    "pinset_offset": offset,
  }


def decode_condensed_pins(header, labels_binary: bytes):
  """Full pin parse: {label: [(index, depth)...]},
  {label: global cc ids} (codec.py:371-418 parity)."""
  layout = decode_condensed_pins_layout(header, labels_binary)
  uniq = layout["uniq"]
  npw = layout["num_pins_width"]
  dw = layout["depth_width"]
  cw = layout["cc_label_width"]
  iw = header.pin_index_width()

  pins = {}
  single_labels = {}
  offset = layout["pinset_offset"]
  for li in range(len(uniq)):
    n_pins = ctoi(labels_binary, offset, npw)
    offset += npw
    idx_arr = np.frombuffer(
      labels_binary, dtype=width2dtype[iw], count=n_pins, offset=offset
    ).astype(np.int64)
    idx_arr = np.cumsum(idx_arr)
    offset += n_pins * iw
    depth_arr = np.frombuffer(
      labels_binary, dtype=width2dtype[dw], count=n_pins, offset=offset
    ).astype(np.int64)
    offset += n_pins * dw
    pins[int(uniq[li])] = list(zip(idx_arr.tolist(), depth_arr.tolist()))

    n_cc = ctoi(labels_binary, offset, npw)
    offset += npw
    cc_ids = np.frombuffer(
      labels_binary, dtype=width2dtype[cw], count=n_cc, offset=offset
    ).astype(np.int64)
    offset += n_cc * cw
    single_labels[int(uniq[li])] = np.cumsum(cc_ids)

  return pins, single_labels


def decode_condensed_pins_label_map(
  header, labels_binary: bytes, cc_labels: np.ndarray, N: int,
  z_start: int, z_end: int, out_dtype,
) -> np.ndarray:
  """Label map for a z window from a pins section
  (labels.hpp:508-617 parity).

  cc_labels: the decoded window-local CCL image (flat, x-fastest, the
  full window), used to resolve which component each pin crosses.
  """
  layout = decode_condensed_pins_layout(header, labels_binary)
  uniq = layout["uniq"]
  cpg = layout["components_per_grid"].astype(np.int64)
  bgcolor = layout["bgcolor"]

  cum = np.concatenate([[0], np.cumsum(cpg)])
  left = int(cum[z_start])
  right = int(cum[z_end])

  label_map = np.full(N, bgcolor, dtype=np.uint64)

  pins, single_labels = decode_condensed_pins(header, labels_binary)

  for li in range(len(uniq)):
    label = int(uniq[li])
    ccs = single_labels[label]
    if len(ccs):
      sel = ccs[(ccs >= left) & (ccs < right)] - left
      label_map[sel] = label

  sxy = header.sx * header.sy
  for li in range(len(uniq)):
    label = int(uniq[li])
    for index, depth in pins[label]:
      pin_z = index // sxy
      loc = index - pin_z * sxy
      z0 = max(pin_z, z_start) - z_start
      z1 = min(pin_z + depth + 1, z_end) - z_start
      for z in range(z0, z1):
        cc_id = cc_labels[loc + sxy * z]
        label_map[cc_id] = label

  return label_map.astype(out_dtype, copy=False)
