"""Label statistics of a crackle stream, computed on a torch device.

Counterpart of crackle_tpu/ops/analytics.py:62-326: voxel_counts,
centroids and bounding_boxes decode each window of 256 slices to
first-visit CCL images on the device (engine.decode_window_ccl_device),
reduce them there to per-component statistics (stats.slice_stats), and
aggregate those on the host per label, which is O(components), in int64
and float64.

Where the reference takes its host loop (condensed-pins streams, a
`label=` query, shapes its stats kernel does not take), the port logs
why and runs the same host loop over for_each_z, the port's copy of the
reference's (analytics.py:24-55), as is point_cloud (:329-428).
"""
import builtins
import logging
from typing import Dict, List, Optional, Union

import numpy as np

from .. import codec
from ..headers import LabelFormat
from ..kernels import engine as _engine
from ..kernels import stats as _stats
from . import labels as _labels_ops
from .ccl import color_connectivity_graph_slice

_min = builtins.min
_max = builtins.max

logger = logging.getLogger("crackle_tpu_torch.analytics")

_DEVICE_WINDOW = 256  # z slices per device stats batch


def _clamp_z_range(head, z_start, z_end):
  z_start = _max(_min(int(z_start), head.sz - 1), 0)
  z_end = head.sz if z_end < 0 else int(z_end)
  z_end = _max(_min(z_end, head.sz), 0)
  if z_start >= z_end:
    raise ValueError(f"crackle: Invalid range: {z_start} - {z_end}")
  return z_start, z_end


def for_each_z(binary: bytes, z_start: int = -1, z_end: int = -1):
  """Yield (vcg, ccl, N, label_map, z) per slice in the window
  (for_each_z_parallel parity; slices stream sequentially on host,
  in parallel on device)."""
  head = codec.header(binary)
  z_start, z_end = _clamp_z_range(head, z_start, z_end)
  if head.sx * head.sy == 0:
    return

  model = codec.decode_markov_model(head, binary)
  codes = codec.crack_codes(binary)
  lb = bytes(codec.raw_labels(binary))

  for z in range(z_start, z_end):
    vcg = codec.slice_crack_code_to_vcg(codes[z], head, model)
    ccl, N = color_connectivity_graph_slice(vcg, head.sx, head.sy)
    if head.label_format == LabelFormat.FLAT:
      label_map = _labels_ops.decode_flat(head, lb, z, z + 1, head.dtype)
    else:
      label_map = _labels_ops.decode_condensed_pins_label_map(
        head, lb, ccl, N, z, z + 1, head.dtype
      )
    yield vcg, ccl, N, label_map, z


def _host_loop(fn: str, reason: str):
  logger.warning("%s: device statistics declined, using the host loop: "
                 "%s", fn, reason)
  return None


def _device_label_stats(binary: bytes, device, fn: str, label):
  """Whole-volume per-(slice, component) stats on `device`.

  Returns (uniq, windows), each window (stats (B, cap_n, 8) int64
  numpy, key_idx (B, cap_n) int64, n_per (B,) int64, z0), or None (with
  the reason logged) where the reference would take its host loop."""
  if label is not None:
    return _host_loop(fn, "a single label was asked for")
  head = codec.header(binary)
  if head.label_format != LabelFormat.FLAT:
    return _host_loop(fn, f"label format {head.label_format} != FLAT")
  uniq, cum, keys = _engine._flat_label_tables(head, binary)
  n_per = cum[1:] - cum[:-1]
  cap_n = _engine._next_pow2(max(int(n_per.max()) if head.sz else 1, 8))
  if not _stats.eligible(head.sx, head.sy, cap_n):
    return _host_loop(fn, f"stats ineligible (sx={head.sx}, sy={head.sy}, "
                          f"cap_n={cap_n})")
  windows = []
  for z0 in range(0, head.sz, _DEVICE_WINDOW):
    z1 = _min(z0 + _DEVICE_WINDOW, head.sz)
    res = _engine.decode_window_ccl_device(binary, z0, z1, device)
    if res is None:
      return _host_loop(fn, f"window [{z0}, {z1}) declined")
    cc, _N, _ = res
    stats = _stats.slice_stats(cc, head.sx, head.sy, cap_n).cpu().numpy()
    key_idx = np.zeros((z1 - z0, cap_n), np.int64)
    for i, z in enumerate(range(z0, z1)):
      n = int(n_per[z])
      key_idx[i, :n] = keys[cum[z]:cum[z] + n]
    windows.append((stats, key_idx, n_per[z0:z1], z0))
  return uniq, windows


def _valid(stats, n_per):
  """Mask of the (slice, component) entries that exist."""
  return np.arange(stats.shape[1])[None, :] < np.asarray(n_per)[:, None]


def _z_window(binary: bytes, label):
  if label is None:
    return 0, -1
  if not codec.contains(binary, label):
    raise ValueError(f"Label {label} not contained in image.")
  return codec.z_range_for_label(binary, label)


def voxel_counts(binary: bytes, label: Optional[int] = None,
                 parallel: int = 0,
                 device="cuda") -> Union[Dict[int, int], int]:
  """Voxels per label (operations.hpp:321-419 parity)."""
  z_start, z_end = _z_window(binary, label)
  head = codec.header(binary)
  if codec.num_labels(binary) == 1:
    single = int(codec.labels(binary)[0])
    vcts = {single: head.voxels()}
  else:
    dev = _device_label_stats(binary, device, "voxel_counts", label)
    if dev is not None:
      uniq, windows = dev
      agg = np.zeros(len(uniq), np.int64)
      for stats, key_idx, n_per, _z0 in windows:
        mask = _valid(stats, n_per)
        np.add.at(agg, key_idx[mask], stats[:, :, _stats.CH_COUNT][mask])
      vcts = dict(zip((int(u) for u in uniq.tolist()),
                      (int(c) for c in agg.tolist())))
    else:
      vcts = {}
      for _vcg, ccl, N, label_map, _z in for_each_z(binary, z_start,
                                                    z_end):
        sub = np.bincount(ccl, minlength=N)
        for lbl, ct in zip(label_map.tolist(), sub.tolist()):
          vcts[lbl] = vcts.get(lbl, 0) + ct
  if label is not None:
    return vcts[label]
  return vcts


def centroids(binary: bytes, label: Optional[int] = None,
              parallel: int = 0, device="cuda"):
  """Centroid (x, y, z) per label (operations.hpp:421-539 parity)."""
  z_start, z_end = _z_window(binary, label)
  sx = codec.header(binary).sx

  dev = _device_label_stats(binary, device, "centroids", label)
  if dev is not None:
    uniq, windows = dev
    # x-sum, y-sum, z-sum, count: exact in int64
    agg = np.zeros((len(uniq), 4), np.int64)
    for stats, key_idx, n_per, z0 in windows:
      mask = _valid(stats, n_per)
      cnt = stats[:, :, _stats.CH_COUNT]
      zs = (z0 + np.arange(stats.shape[0], dtype=np.int64))[:, None]
      ki = key_idx[mask]
      np.add.at(agg[:, 0], ki, stats[:, :, _stats.CH_XSUM][mask])
      np.add.at(agg[:, 1], ki, stats[:, :, _stats.CH_YSUM][mask])
      np.add.at(agg[:, 2], ki, (zs * cnt)[mask])
      np.add.at(agg[:, 3], ki, cnt[mask])
    a = agg.astype(np.float64)
    return {
      int(lbl): (r[0] / r[3], r[1] / r[3], r[2] / r[3])
      for lbl, r in zip(uniq.tolist(), a)
    }

  acc: Dict[int, np.ndarray] = {}
  for _vcg, ccl, N, label_map, z in for_each_z(binary, z_start, z_end):
    idx = np.arange(len(ccl))
    xs = idx % sx
    ys = idx // sx
    sub_x = np.bincount(ccl, weights=xs, minlength=N)
    sub_y = np.bincount(ccl, weights=ys, minlength=N)
    sub_n = np.bincount(ccl, minlength=N)
    for i, lbl in enumerate(label_map.tolist()):
      a = acc.setdefault(lbl, np.zeros(4))
      a[0] += sub_x[i]
      a[1] += sub_y[i]
      a[2] += z * sub_n[i]
      a[3] += sub_n[i]

  out = {
    lbl: (a[0] / a[3], a[1] / a[3], a[2] / a[3]) for lbl, a in acc.items()
  }
  if label is not None:
    return out[label]
  return out


def bounding_boxes(binary: bytes, label: Optional[int] = None,
                   parallel: int = 0, no_slice_conversion: bool = False,
                   device="cuda"):
  """Axis-aligned bounding boxes per label (operations.hpp:541-665
  parity). Returns [xmin,ymin,zmin,xmax,ymax,zmax] arrays or slice
  triples."""
  z_start, z_end = _z_window(binary, label)
  head = codec.header(binary)
  sx = head.sx

  if codec.num_labels(binary) == 1:
    single = int(codec.labels(binary)[0])
    bboxes = {
      single: np.array([0, 0, 0, head.sx - 1, head.sy - 1, head.sz - 1],
                       dtype=np.uint32),
    }
  else:
    dev = _device_label_stats(binary, device, "bounding_boxes", label)
    if dev is not None:
      uniq, windows = dev
      mins = np.full((len(uniq), 3), np.iinfo(np.int64).max)
      maxs = np.full((len(uniq), 3), -1, np.int64)
      for stats, key_idx, n_per, z0 in windows:
        mask = _valid(stats, n_per)
        zs = np.broadcast_to((z0 + np.arange(stats.shape[0]))[:, None],
                             mask.shape)
        ki = key_idx[mask]
        np.minimum.at(mins[:, 0], ki, stats[:, :, _stats.CH_XMIN][mask])
        np.minimum.at(mins[:, 1], ki, stats[:, :, _stats.CH_YMIN][mask])
        np.minimum.at(mins[:, 2], ki, zs[mask])
        np.maximum.at(maxs[:, 0], ki, stats[:, :, _stats.CH_XMAX][mask])
        np.maximum.at(maxs[:, 1], ki, stats[:, :, _stats.CH_YMAX][mask])
        np.maximum.at(maxs[:, 2], ki, zs[mask])
      bboxes = {
        int(lbl): np.concatenate([mins[i], maxs[i]]).astype(np.uint32)
        for i, lbl in enumerate(uniq.tolist())
      }
    else:
      bboxes = {}
      for _vcg, ccl, N, label_map, z in for_each_z(binary, z_start,
                                                   z_end):
        idx = np.arange(len(ccl))
        xs = idx % sx
        ys = idx // sx
        INT = np.iinfo(np.int64).max
        xmin = np.full(N, INT)
        ymin = np.full(N, INT)
        xmax = np.zeros(N, dtype=np.int64)
        ymax = np.zeros(N, dtype=np.int64)
        np.minimum.at(xmin, ccl, xs)
        np.minimum.at(ymin, ccl, ys)
        np.maximum.at(xmax, ccl, xs)
        np.maximum.at(ymax, ccl, ys)
        for i, lbl in enumerate(label_map.tolist()):
          if lbl in bboxes:
            b = bboxes[lbl]
            b[0] = _min(b[0], xmin[i])
            b[1] = _min(b[1], ymin[i])
            b[2] = _min(b[2], z)
            b[3] = _max(b[3], xmax[i])
            b[4] = _max(b[4], ymax[i])
            b[5] = _max(b[5], z)
          else:
            bboxes[lbl] = np.array(
              [xmin[i], ymin[i], z, xmax[i], ymax[i], z], dtype=np.int64)
      bboxes = {k: v.astype(np.uint32) for k, v in bboxes.items()}

  if no_slice_conversion:
    if label is not None:
      return bboxes[label]
    return bboxes

  out = {
    lbl: (
      slice(int(b[0]), int(b[3]) + 1),
      slice(int(b[1]), int(b[4]) + 1),
      slice(int(b[2]), int(b[5]) + 1),
    )
    for lbl, b in bboxes.items()
  }
  if label is not None:
    return out[label]
  return out


def point_cloud(binary: bytes, label=None, parallel: int = 0,
                z_start: int = -1, z_end: int = -1,
                skip_background: bool = True):
  """Surface point clouds per label without full decompression
  (operations.hpp:185-319). A surface point is a voxel of the label
  adjacent to an impassable crack edge or the image border.

  Note: unlike the reference's Moore-neighbor contour walk, points are
  emitted uniquely (the reference may duplicate walk start points)."""
  scalar_input = False
  if isinstance(label, (int, np.integer)):
    scalar_input = True
    label = [int(label)]

  head = codec.header(binary)
  opt_z_start = z_start == -1
  opt_z_end = z_end == -1

  if isinstance(label, (list, tuple)):
    if z_start == -1:
      z_start = head.sz
    if z_end == -1:
      z_end = -1
    for lbl in label:
      if not codec.contains(binary, lbl):
        raise ValueError(f"Label {lbl} not contained in image.")
      elif opt_z_start or opt_z_end:
        zs, ze = codec.z_range_for_label(binary, lbl)
        if opt_z_start:
          z_start = _min(z_start, zs)
        if opt_z_end:
          z_end = _max(z_end, ze)
        if z_start == 0 and z_end == head.sz:
          break

  if z_start == -1:
    z_start = 0
  if z_end == -1:
    z_end = head.sz

  selective = label is not None
  label_set = set(label) if selective else None

  sx, sy = head.sx, head.sy
  all_pts: List[np.ndarray] = []
  all_lbls: List[np.ndarray] = []

  for vcg, ccl, N, label_map, z in for_each_z(binary, z_start, z_end):
    v = vcg.reshape(sy, sx)
    boundary = (v & 0b1111) != 0b1111
    boundary[0, :] = True
    boundary[-1, :] = True
    boundary[:, 0] = True
    boundary[:, -1] = True
    bidx = np.flatnonzero(boundary.ravel())
    if len(bidx) == 0:
      continue
    lbls = np.asarray(label_map)[ccl[bidx]]
    if skip_background or selective:
      if selective:
        keep = np.isin(lbls, np.asarray(sorted(label_set),
                                        dtype=lbls.dtype))
        if skip_background:
          # the background skip applies even with an explicit label
          # list (operations.hpp:236 applies it unconditionally)
          keep &= lbls != 0
      else:
        keep = lbls != 0
      bidx, lbls = bidx[keep], lbls[keep]
      if len(bidx) == 0:
        continue
    pts = np.empty((len(bidx), 3), np.uint16)
    pts[:, 0] = bidx % sx
    pts[:, 1] = bidx // sx
    pts[:, 2] = z
    all_pts.append(pts)
    all_lbls.append(lbls)

  ptc: Dict[int, np.ndarray] = {}
  if all_pts:
    # one global sort-based group-by instead of a per-label mask per
    # slice (points within a label stay in slice/raster order because
    # the sort is stable)
    pts = np.concatenate(all_pts)
    lbls = np.concatenate(all_lbls)
    order = np.argsort(lbls, kind='stable')
    pts, lbls = pts[order], lbls[order]
    uniq, starts = np.unique(lbls, return_index=True)
    bounds = np.append(starts, len(lbls))
    ptc = {
      int(u): np.ascontiguousarray(pts[bounds[i]:bounds[i + 1]])
      for i, u in enumerate(uniq)
    }
  if len(ptc) == 0:
    if label:
      return np.zeros([0, 3], dtype=np.uint16, order="C")
    return {}
  if scalar_input:
    return ptc[label[0]]
  return ptc
