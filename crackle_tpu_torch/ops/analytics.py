"""Label statistics of a crackle stream, computed on a torch device.

Counterpart of crackle_tpu/ops/analytics.py:62-326: voxel_counts,
centroids and bounding_boxes decode each window of 256 slices to
first-visit CCL images on the device (engine.decode_window_ccl_device),
reduce them there to per-component statistics (stats.slice_stats), and
aggregate those on the host per label, which is O(components), in int64
and float64.

Where the reference takes its host loop (condensed-pins streams, a
`label=` query, shapes its stats kernel does not take), the port logs
why and runs the same host loop, built on crackle_tpu.ops.analytics.
for_each_z (the reference's public functions would import JAX).
"""
import builtins
import logging
from typing import Dict, Optional, Union

import numpy as np

from crackle_tpu import codec
from crackle_tpu.headers import LabelFormat
from crackle_tpu.ops.analytics import for_each_z

from ..kernels import engine as _engine
from ..kernels import stats as _stats

_min = builtins.min
_max = builtins.max

logger = logging.getLogger("crackle_tpu_torch.analytics")

_DEVICE_WINDOW = 256  # z slices per device stats batch


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
