"""Decode-lite analytics of a crackle stream, on a torch device where
the codec's engine says so.

The port of crackle_tpu/ops/analytics.py. voxel_counts, centroids and
bounding_boxes decode each window of 256 slices to first-visit CCL
images on the device (engine.decode_window_ccl_device), reduce them
there to per-component statistics (stats.slice_stats), and aggregate
those on the host per label, which is O(components), in int64 and
float64; device=None takes the host loop.

voxel_connectivity_graph and contacts take a device route under a torch
engine (codec._torch_engine_enabled(), on the engine's device): the VCG
from the replay kernels alone (engine.decode_window_vcg_device), the z
bits and the contacts from the labels each window leaves on the device
(engine.decode_window_labels_device). Under set_engine('numpy') they run
the reference's host loops (analytics.py:431-531), as the reference picks
its device path by backend (analytics.py:65-73).

Where the device route declines (condensed-pins statistics, a `label=`
query, shapes the stats kernel does not take, a window the engine
declines), the port logs why and runs the same host loop over
for_each_z, the port's copy of the reference's (analytics.py:24-55), as
are point_cloud (:329-428), each (:536-589), mode_pooling_2x2x1
(:592-647), connected_components_3d (:650-737) and cache_meta
(:740-789), whose decodes and encodes go through the port's codec and so
to the card under a torch engine.
"""
import builtins
import logging
import os
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

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
  logger.warning("%s: the device route declined, using the host loop: "
                 "%s", fn, reason)
  return None


def _engine_device():
  """The codec engine's torch device where it is enabled, else None
  (the host loops)."""
  return codec._DEVICE if codec._torch_engine_enabled() else None


def _device_label_stats(binary: bytes, device, fn: str, label):
  """Whole-volume per-(slice, component) stats on `device`.

  Returns (uniq, windows), each window (stats (B, cap_n, 8) int64
  numpy, key_idx (B, cap_n) int64, n_per (B,) int64, z0), or None where
  the reference would take its host loop (with the reason logged) and
  for device=None."""
  if device is None:
    return None
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
  """Voxels per label (operations.hpp:321-419 parity); device=None
  takes the host loop."""
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
  """Centroid (x, y, z) per label (operations.hpp:421-539 parity);
  device=None takes the host loop."""
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
  triples. device=None takes the host loop."""
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


# ---------------------------------------------------------------------------
# Device routes of the VCG and the contacts
# ---------------------------------------------------------------------------

def _route_device(head):
  """The device of the VCG and contacts routes: the codec engine's where
  it is enabled, else None (the reference's host loops, which also take
  an empty volume)."""
  if head.sx * head.sy * head.sz == 0:
    return None
  return _engine_device()


def _signed(labels):
  """uint32/uint64 labels as their int32/int64 view (torch's unsigned
  types have few kernels)."""
  return labels.view({torch.uint32: torch.int32,
                      torch.uint64: torch.int64}[labels.dtype])


def _device_vcg(binary: bytes, head, connectivity: int, device):
  """voxel_connectivity_graph on `device`, in windows of _DEVICE_WINDOW
  slices: each window's 4-bit VCG from the replay kernels, cast to uint8
  and copied into a (sz, sy, sx) host array whose transpose is the
  reference's (sx, sy, sz) F-order result. With 6-connectivity and sz >
  1 the windows decode their labels too (from the same VCG), and where
  two slices' labels are equal the lower slice takes +z (0b010000) and
  the upper -z (0b100000), across window seams too, then the first slice
  -z and the last +z. Returns None (logged) where a window declines."""
  sx, sy, sz = head.sx, head.sy, head.sz
  zbits = connectivity == 6 and sz > 1
  out = np.empty((sz, sy, sx), np.uint8)
  prev = None
  for z0 in range(0, sz, _DEVICE_WINDOW):
    z1 = _min(z0 + _DEVICE_WINDOW, sz)
    if zbits:
      res = _engine.decode_window_labels_device(binary, z0, z1, device)
    else:
      res = _engine.decode_window_vcg_device(binary, z0, z1, device)
    if res is None:
      return _host_loop("voxel_connectivity_graph",
                        f"window [{z0}, {z1}) declined")
    if not zbits:
      out[z0:z1] = res.to(torch.uint8).cpu().numpy()
      continue
    labels, _cc, vcg = res
    lab = _signed(labels)
    vcg = vcg.reshape(z1 - z0, sx * sy).to(torch.uint8)
    same = (lab[1:] == lab[:-1]).to(torch.uint8)
    vcg[:-1] |= same << 4
    vcg[1:] |= same << 5
    if prev is not None:
      seam = (lab[0] == prev).to(torch.uint8)
      vcg[0] |= seam << 5
      out[z0 - 1] |= (seam << 4).reshape(sy, sx).cpu().numpy()
    prev = lab[-1]
    out[z0:z1] = vcg.reshape(z1 - z0, sy, sx).cpu().numpy()
  if zbits:
    out[0] |= 0b100000
    out[sz - 1] |= 0b010000
  return out.transpose(2, 1, 0)


_SIGN = -(1 << 63)


def _order_keys(labels, head):
  """Labels (B, n) uint32/uint64 on a device -> int64 keys whose order
  is that of the values the reference's host loop compares
  (label_map.astype(np.uint64)): cut to the header's width, sign-extended
  for signed streams, then the sign bit flipped so that signed order is
  unsigned order. Label 0 becomes _SIGN."""
  v = _signed(labels).to(torch.int64)
  bits = 8 * head.data_width
  if labels.dtype == torch.uint32:
    v = v & 0xFFFFFFFF
  if bits < 64:
    v = (v << (64 - bits)) >> (64 - bits) if head.signed \
      else v & ((1 << bits) - 1)
  return v ^ _SIGN


def _pair_ids(lo, hi):
  """Dense ids of the (lo, hi) rows of two int64 tensors, numbered in
  (lo, hi) order, through one-dimensional uniques (the labels to dense
  ids, then the pairs of those). Returns (each row's id, the distinct
  pairs (P, 2))."""
  u, inv = torch.unique(torch.cat([lo, hi]), return_inverse=True)
  n = len(u)
  up, ids = torch.unique(inv[:len(lo)] * n + inv[len(lo):],
                         return_inverse=True)
  return ids, torch.stack([u[up // n], u[up % n]], 1)


def _window_contacts(pairs, zs, axes):
  """The distinct (z, axis, lo, hi) rows of the label pairs (a, b) in
  pairs (order keys of one shape), z and axis broadcast to them, and
  their counts, on the device: pairs of different labels, background
  left out. Returns (z * 3 + axis, lo, hi, count), sorted by (z, axis,
  lo, hi), or None where there is no such pair."""
  lo, hi, za = [], [], []
  for (a, b), z, axis in zip(pairs, zs, axes):
    m = (a != b) & (a != _SIGN) & (b != _SIGN)
    lo.append(torch.minimum(a, b)[m])
    hi.append(torch.maximum(a, b)[m])
    za.append((z * 3 + axis).expand_as(a)[m])
  lo, hi, za = torch.cat(lo), torch.cat(hi), torch.cat(za)
  if not len(lo):
    return None
  ids, uniq = _pair_ids(lo, hi)
  rows, counts = torch.unique(za * len(uniq) + ids, return_counts=True)
  pair = uniq[rows % len(uniq)]
  return rows // len(uniq), pair[:, 0], pair[:, 1], counts


def _device_contact_rows(binary: bytes, head, device):
  """The per-(slice, axis) contact counts of contacts, from the labels of
  each window of _DEVICE_WINDOW slices on `device`: the x and y pairs of
  each slice and the z pair with the slice below it (across window seams
  too), then the distinct pairs over all windows. Returns (the pairs (P,
  2) uint64, each row's pair id, axis and count, the rows in the host
  loop's order: by z, then axis x, y, z), or None (logged) where a window
  declines."""
  sx, sy, sz = head.sx, head.sy, head.sz
  parts = []
  prev = None
  for z0 in range(0, sz, _DEVICE_WINDOW):
    z1 = _min(z0 + _DEVICE_WINDOW, sz)
    res = _engine.decode_window_labels_device(binary, z0, z1, device)
    if res is None:
      return _host_loop("contacts", f"window [{z0}, {z1}) declined")
    K = _order_keys(res[0], head).reshape(z1 - z0, sy, sx)
    zs = torch.arange(z0, z1, device=K.device)[:, None, None]
    pairs = [(K[:, :, :-1], K[:, :, 1:]), (K[:, :-1, :], K[:, 1:, :]),
             (K[:-1], K[1:])]
    z_of = [zs, zs, zs[1:]]
    axes = [0, 1, 2]
    if prev is not None:
      pairs.append((prev[None], K[:1]))
      z_of.append(zs[:1])
      axes.append(2)
    prev = K[-1]
    rows = _window_contacts(pairs, z_of, axes)
    if rows is not None:
      parts.append(rows)
  if not parts:
    return np.zeros((0, 2), np.uint64), *(np.zeros(0, np.int64),) * 3
  # each window's rows are sorted by (z, axis), and the windows run in z
  za, lo, hi, counts = (torch.cat(c) for c in zip(*parts))
  ids, uniq = _pair_ids(lo, hi)
  return ((uniq.cpu().numpy() ^ _SIGN).view(np.uint64), ids.cpu().numpy(),
          (za % 3).cpu().numpy(), counts.cpu().numpy())


def _contact_sums(pairs, ids, axis, counts, areas):
  """The host loop's reduction (analytics.py:523-531): one row per
  (slice, axis, pair), its area count * area, summed per pair by one
  np.bincount in row order, so each pair's float sum is the host
  loop's."""
  sums = np.bincount(ids, weights=counts * np.asarray(areas)[axis],
                     minlength=len(pairs))
  return {
    (int(a), int(b)): float(x)
    for (a, b), x in zip(pairs.tolist(), sums.tolist())
  }


def voxel_connectivity_graph(binary: bytes, connectivity: int = 6,
                             parallel: int = 0) -> np.ndarray:
  """4- or 6-connected VCG as uint8 (bits 00zz-y+y-x+x, LSB right)
  reshaped to (sx, sy, sz) F-order (operations.hpp:667-841 parity): on
  the codec engine's device where it is enabled (_device_vcg), else the
  reference's host loop."""
  if connectivity not in (4, 6):
    raise ValueError(
      f"Only 4 and 6 connected are supported. Got: {connectivity}"
    )
  head = codec.header(binary)
  device = _route_device(head)
  if device is not None:
    out = _device_vcg(binary, head, connectivity, device)
    if out is not None:
      return out
  sx, sy, sz = head.sx, head.sy, head.sz
  sxy = sx * sy

  model = codec.decode_markov_model(head, binary)
  codes = codec.crack_codes(binary)
  lb = bytes(codec.raw_labels(binary))

  vcg = np.zeros((sz, sxy), dtype=np.uint8)
  for z in range(sz):
    vcg[z] = codec.slice_crack_code_to_vcg(codes[z], head, model)

  if sz == 1 or connectivity == 4:
    return vcg.reshape(sz, sy, sx).transpose(2, 1, 0).copy(order='F')

  prev_labels = None
  for z in range(sz):
    ccl, N = color_connectivity_graph_slice(vcg[z], sx, sy)
    if head.label_format == LabelFormat.FLAT:
      label_map = _labels_ops.decode_flat(head, lb, z, z + 1, np.uint64)
    else:
      label_map = _labels_ops.decode_condensed_pins_label_map(
        head, lb, ccl, N, z, z + 1, np.uint64
      )
    cur_labels = label_map[ccl]
    if prev_labels is not None:
      same = cur_labels == prev_labels
      vcg[z - 1][same] |= 0b010000
      vcg[z][same] |= 0b100000
    prev_labels = cur_labels

  # z boundaries passable for compatibility
  vcg[0] |= 0b100000
  vcg[sz - 1] |= 0b010000

  return vcg.reshape(sz, sy, sx).transpose(2, 1, 0).copy(order='F')


def contacts(binary: bytes,
             anisotropy: Tuple[float, float, float] = (1.0, 1.0, 1.0)
             ) -> Dict[Tuple[int, int], float]:
  """6-connected contact surface areas between labels, background (0)
  excluded (operations.hpp:849-1037 parity): from the labels on the
  codec engine's device where it is enabled (_device_contact_rows),
  else the reference's host loop. Both sum each pair's areas in the
  same order, so the floats are the same."""
  wx, wy, wz = anisotropy
  area_x = wy * wz
  area_y = wx * wz
  area_z = wx * wy

  head = codec.header(binary)
  device = _route_device(head)
  if device is not None:
    rows = _device_contact_rows(binary, head, device)
    if rows is not None:
      return _contact_sums(*rows, (area_x, area_y, area_z))
  sx, sy = head.sx, head.sy

  acc_pairs: List[np.ndarray] = []
  acc_areas: List[np.ndarray] = []

  def add_edges(a: np.ndarray, b: np.ndarray, area: float):
    m = (a != b) & (a != 0) & (b != 0)
    if not m.any():
      return
    lo = np.minimum(a[m], b[m])
    hi = np.maximum(a[m], b[m])
    # pre-reduce within the slice, accumulate (pair, area) rows; one
    # global reduction at the end replaces a python dict update per pair
    if lo.size and int(lo.max()) < (1 << 32) and int(hi.max()) < (1 << 32):
      pairs, counts = np.unique((lo << 32) | hi, return_counts=True)
      acc_pairs.append(np.stack([pairs >> 32, pairs & 0xffffffff], 1))
      acc_areas.append(counts * area)
    else:
      pairs, counts = np.unique(
        np.stack([lo, hi], axis=1), axis=0, return_counts=True)
      acc_pairs.append(pairs)
      acc_areas.append(counts * area)

  prev = None
  for vcg, ccl, N, label_map, z in for_each_z(binary, 0, -1):
    cur = label_map[ccl].astype(np.uint64).reshape(sy, sx)
    add_edges(cur[:, :-1].ravel(), cur[:, 1:].ravel(), area_x)
    add_edges(cur[:-1, :].ravel(), cur[1:, :].ravel(), area_y)
    if prev is not None:
      add_edges(prev.ravel(), cur.ravel(), area_z)
    prev = cur

  if not acc_pairs:
    return {}
  keys = np.concatenate(acc_pairs)
  areas = np.concatenate(acc_areas)
  uniq, inv = np.unique(keys, axis=0, return_inverse=True)
  sums = np.bincount(inv.ravel(), weights=areas, minlength=len(uniq))
  return {
    (int(a), int(b)): float(s)
    for (a, b), s in zip(uniq.tolist(), sums.tolist())
  }


# ---------------------------------------------------------------------------
# Iteration
# ---------------------------------------------------------------------------

def each(binary: bytes, parallel: int = 0, crop: bool = True,
         labels: Optional[Iterator[int]] = None, multi: bool = False):
  """Iterate (label, binary_image) over each label; multi mode colors
  up to 255 labels per decode cycle (codec.py:1067-1149 parity). The
  crop boxes come from bounding_boxes on the codec engine's device, or
  its host loop."""
  from ..operations import mask_except, renumber

  all_labels = codec.labels(binary)
  if labels is None:
    labels = all_labels.tolist()
  else:
    labels = list(set(all_labels.tolist()).intersection(set(labels)))

  if crop and not multi:
    bbxes = bounding_boxes(binary, no_slice_conversion=True,
                           device=_engine_device())
    head = codec.header(binary)

  class BinaryImageIterator:
    def __len__(self):
      return len(labels)

    def __iter__(self):
      for label in labels:
        binimg = codec.decompress(
          binary, label=label, parallel=parallel, crop=crop
        )
        if crop:
          slc = bbxes[label]
          s = (slice(int(slc[0]), int(slc[3]) + 1),
               slice(int(slc[1]), int(slc[4]) + 1), slice(None))
          if head.fortran_order:
            binimg = np.asfortranarray(binimg[s])
          else:
            binimg = np.ascontiguousarray(binimg[s])
        yield (label, binimg)

  class MultiImageIterator:
    def __len__(self):
      return len(labels)

    def __iter__(self):
      cycles = int(np.ceil(len(labels) / 255.0))
      for ci in range(cycles):
        subset = labels[ci * 255:(ci + 1) * 255]
        sub_binary = mask_except(binary, subset, parallel=parallel)
        sub_binary, mapping = renumber(sub_binary, parallel=parallel)
        image = codec.decompress(sub_binary, parallel=parallel)
        for label in subset:
          yield (label, mapping[label], image)

  return MultiImageIterator() if multi else BinaryImageIterator()


# ---------------------------------------------------------------------------
# Downsampling / 3D CCL / metadata cache
# ---------------------------------------------------------------------------

def _mode_2x2(a: np.ndarray) -> np.ndarray:
  """Mode of 2x2 blocks of a (sy, sx) array; odd edges replicate."""
  sy, sx = a.shape
  ey, ex = (sy + 1) // 2 * 2, (sx + 1) // 2 * 2
  p = np.empty((ey, ex), dtype=a.dtype)
  p[:sy, :sx] = a
  if ex > sx:
    p[:sy, sx:] = a[:, -1:]
  if ey > sy:
    p[sy:, :] = p[sy - 1:sy, :]
  q = p.reshape(ey // 2, 2, ex // 2, 2).transpose(0, 2, 1, 3) \
       .reshape(-1, 4)
  va, vb, vc, vd = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
  out = np.where(
    (va == vb) | (va == vc) | (va == vd), va,
    np.where((vb == vc) | (vb == vd), vb,
             np.where(vc == vd, vc, va))
  )
  return out.reshape(ey // 2, ex // 2)


def mode_pooling_2x2x1(binary: bytes, parallel: int = 0) -> List[bytes]:
  """Downsample each slice 2x2 by mode pooling and recompress;
  returns per-slice binaries for zstack
  (operations.hpp:1201-1352 parity).

  Decodes in bounded z-windows (peak host memory stays O(window),
  not O(volume)), then per-slice pooled recompression on a thread
  pool — the encoder's hot path is native code that releases the GIL,
  matching the reference's for_each_z_parallel template
  (operations.hpp:89-182)."""
  import concurrent.futures as _fut
  head = codec.header(binary)
  n_workers = parallel if parallel > 0 else (os.cpu_count() or 1)
  n_workers = _min(_max(n_workers, 1), _max(head.sz, 1))

  # window sized to ~64 MB of decoded voxels (min one slice)
  slice_bytes = max(head.sx * head.sy * head.data_width, 1)
  window = _min(_max(int(64e6) // slice_bytes, 1), max(head.sz, 1))

  out: List[bytes] = []
  for z0 in range(0, head.sz, window):
    z1 = _min(z0 + window, head.sz)
    vol = codec.decompress_range(binary, z0, z1, parallel=parallel)

    def pool_one(z: int) -> bytes:
      a = np.asfortranarray(vol[:, :, z - z0])
      pooled = _mode_2x2(a.T).T  # operate in (sy, sx) then back
      return codec.compress(np.asfortranarray(pooled[:, :, np.newaxis]))

    if n_workers == 1 or z1 - z0 <= 1:
      out.extend(pool_one(z) for z in range(z0, z1))
    else:
      with _fut.ThreadPoolExecutor(n_workers) as ex:
        out.extend(ex.map(pool_one, range(z0, z1)))
  return out


def connected_components_3d(binary: bytes, connectivity: int = 26,
                            binary_image: bool = False,
                            memory_target: int = int(100e6),
                            progress: bool = False,
                            return_mapping: bool = False):
  """3D connected components of the stream as a new stream
  (operations.py:859-934 parity, using an internal multilabel 3D CCL
  instead of the external cc3d package)."""
  from scipy import sparse
  from scipy.sparse import csgraph

  if connectivity not in (6, 26):
    raise ValueError(f"connectivity must be 6 or 26, got {connectivity}")

  arr = codec.decompress(binary)
  sx, sy, sz = arr.shape
  a = arr
  if binary_image:
    a = (arr != 0).astype(np.uint8)

  n = a.size
  flat = np.asfortranarray(a).ravel(order='F')
  idx = np.arange(n, dtype=np.int64).reshape(a.shape, order='F')

  offsets = []
  if connectivity == 6:
    offsets = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
  else:
    for dz in (0, 1):
      for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
          if (dx, dy, dz) <= (0, 0, 0):
            continue
          offsets.append((dx, dy, dz))

  ei_list, ej_list = [], []
  for dx, dy, dz in offsets:
    src = idx[_max(0, -dx):sx - _max(0, dx),
              _max(0, -dy):sy - _max(0, dy),
              _max(0, -dz):sz - _max(0, dz)].ravel()
    dst = idx[_max(0, dx):sx - _max(0, -dx),
              _max(0, dy):sy - _max(0, -dy),
              _max(0, dz):sz - _max(0, -dz)].ravel()
    same = flat[src] == flat[dst]
    if binary_image:
      same &= flat[src] != 0
    ei_list.append(src[same])
    ej_list.append(dst[same])

  ei = np.concatenate(ei_list)
  ej = np.concatenate(ej_list)
  g = sparse.coo_matrix(
    (np.ones(len(ei), dtype=bool), (ei, ej)), shape=(n, n)
  )
  ncomp, comp = csgraph.connected_components(g, directed=False)

  # background stays 0; foreground components numbered 1..N by first
  # occurrence (cc3d convention keeps 0 only in binary_image mode)
  from .ccl import first_visit_renumber
  comp, _ = first_visit_renumber(comp, n, dtype=np.uint64)
  if binary_image:
    bgmask = flat == 0
    out = comp + 1
    out[bgmask] = 0
    # renumber foreground densely
    uniq = np.unique(out[~bgmask]) if (~bgmask).any() else np.zeros(0)
    remap_arr = np.searchsorted(uniq, out[~bgmask]) + 1
    final = np.zeros(n, dtype=np.uint64)
    final[~bgmask] = remap_arr
    comp = final
  else:
    comp = comp + 1

  ccl_vol = comp.reshape((sx, sy, sz), order='F')
  from ..lib import fit_dtype
  dt = fit_dtype(np.uint64, int(ccl_vol.max()) if n else 0)
  ccl_binary = codec.compress(np.asfortranarray(ccl_vol.astype(dt)))
  ccl_binary = codec.condense_unique(ccl_binary)

  if not return_mapping:
    return ccl_binary

  mapping = {}
  cflat = comp
  uniq_c, first_idx = np.unique(cflat, return_index=True)
  for c, fi in zip(uniq_c.tolist(), first_idx.tolist()):
    mapping[int(c)] = int(flat[fi]) if not binary_image else int(arr.ravel(order='F')[fi])
  return (ccl_binary, mapping)


def cache_meta(binary: bytes, path: str, parallel: int = 0):
  """Voxel counts + bounding boxes saved as a parquet sidecar
  (codec.py:1151-1216 parity), the statistics on the codec engine's
  device or by the host loop."""
  import pyarrow as pa
  import pyarrow.parquet as pq

  device = _engine_device()
  cts = voxel_counts(binary, parallel=parallel, device=device)
  bbxs = bounding_boxes(binary, parallel=parallel, no_slice_conversion=True,
                        device=device)

  labels_arr = np.asarray(sorted(cts.keys()), dtype=np.uint64)
  cts_arr = np.asarray([cts[l] for l in labels_arr], dtype=np.uint32)

  head = codec.header(binary)
  max_dim = _max(head.sx, head.sy, head.sz)
  if max_dim <= np.iinfo(np.uint16).max:
    bbox_type = pa.uint16()
    bbox_dtype = np.uint16
  else:
    bbox_type = pa.uint32()
    bbox_dtype = np.uint32

  cols = {
    'label': labels_arr,
    'voxel_count': cts_arr,
    'min_x': np.asarray([bbxs[l][0] for l in labels_arr], dtype=bbox_dtype),
    'max_x': np.asarray([bbxs[l][3] for l in labels_arr], dtype=bbox_dtype),
    'min_y': np.asarray([bbxs[l][1] for l in labels_arr], dtype=bbox_dtype),
    'max_y': np.asarray([bbxs[l][4] for l in labels_arr], dtype=bbox_dtype),
  }
  schema = [
    pa.field('label', pa.uint64()),
    pa.field('voxel_count', pa.uint32()),
    pa.field('min_x', bbox_type),
    pa.field('max_x', bbox_type),
    pa.field('min_y', bbox_type),
    pa.field('max_y', bbox_type),
  ]
  if head.sz > 1:
    schema.append(pa.field('min_z', bbox_type))
    schema.append(pa.field('max_z', bbox_type))
    cols['min_z'] = np.asarray(
      [bbxs[l][2] for l in labels_arr], dtype=bbox_dtype
    )
    cols['max_z'] = np.asarray(
      [bbxs[l][5] for l in labels_arr], dtype=bbox_dtype
    )

  table = pa.table(cols, schema=pa.schema(schema))
  pq.write_table(table, path, compression="zstd")
  return table
