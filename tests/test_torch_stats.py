"""The port's slice statistics and device analytics on the CPU: the
plain version of the slice_stats kernel against stats_pallas (interpret
mode), and voxel_counts / centroids / bounding_boxes against the
reference's device path and its host loop. Counts, sums and extents are
compared exactly (the reference's f32 sums are exact at these sizes);
centroids within rtol 1e-12, the reference test's own tolerance."""
import logging

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import crackle_tpu as crackle
import crackle_tpu.ops.analytics as A
from crackle_tpu.kernels import ccl_pallas, stats_pallas
import crackle_tpu_torch as ct
from crackle_tpu_torch.kernels import ccl, stats

from test_jax_decode import random_volume
from test_torch_ccl import labels_to_vcg, smooth_labels
from test_torch_pins import pins_volume


@pytest.fixture
def interpret(monkeypatch):
  monkeypatch.setattr(ccl_pallas, "INTERPRET", True)
  jax.clear_caches()
  yield
  jax.clear_caches()


def _hold_to_pallas(cc, sx, sy, cap_n):
  """slice_stats (the plain version, on the CPU) against stats_pallas in
  interpret mode: counts, sums and maxes equal, mins equal once the
  port's EMPTY_MIN is read as the reference's f32 3e38."""
  want = np.asarray(stats_pallas.slice_stats(
    jnp.asarray(cc.numpy()), sx, sy, cap_n))
  got = stats.slice_stats(cc, sx, sy, cap_n)
  assert got.dtype == torch.int64 and got.shape == (cc.shape[0], cap_n, 8)
  got = got.numpy()
  for ch in (stats.CH_COUNT, stats.CH_XSUM, stats.CH_YSUM, stats.CH_XMAX,
             stats.CH_YMAX):
    np.testing.assert_array_equal(got[:, :, ch], want[:, :, ch])
  for ch in (stats.CH_XMIN, stats.CH_YMIN):
    mapped = np.where(got[:, :, ch] == stats.EMPTY_MIN,
                      stats_pallas._F32MAX, got[:, :, ch])
    np.testing.assert_array_equal(mapped.astype(np.float32),
                                  want[:, :, ch])


@pytest.mark.parametrize("B,sy,sx,n,rounds", [(3, 24, 40, 6, 12),
                                              (2, 16, 8, 40, 0),
                                              (1, 8, 33, 3, 4)])
def test_slice_stats_matches_pallas(interpret, B, sy, sx, n, rounds):
  cc, N, _ = ccl.ccl_paint(torch.from_numpy(
    labels_to_vcg(smooth_labels(B, sy, sx, n, sx, rounds))))
  _hold_to_pallas(cc, sx, sy, ccl._pow2_cap(int(N.max())))


def stats_edge_case(name):
  """(cc (B, sy*sx) int32, sx, sy, cap_n) of the slice_stats kernel's
  seams and extremes. The kernel walks bands of stats.BAND_PX pixels
  (whole rows) and, in each, warps of spans of 128 pixels; the card
  tests shrink BAND_PX to put band seams inside these shapes. The first
  four are first-visit CCL images, as the reference takes them."""
  def paint(labels):
    return ccl.ccl_paint_plain(torch.from_numpy(labels_to_vcg(labels)))[0]

  if name == "band seams":
    # a bar through all 40 rows whose 151-pixel rows cross span seams,
    # on smooth labels; sy = 40 is no multiple of 3-row bands
    labels = smooth_labels(2, 40, 300, 5, 3, 8) + 1
    labels[:, :, 100:251] = 0
    cc, sx, sy = paint(labels), 300, 40
  elif name == "checkerboard":  # no links: every pixel its component
    cc, sx, sy = paint(np.arange(2 * 8 * 16).reshape(2, 8, 16)), 16, 8
  elif name == "one component":
    cc, sx, sy = paint(np.zeros((2, 64, 64), np.int32)), 64, 64
  elif name == "sx 8":
    cc, sx, sy = paint(smooth_labels(3, 64, 8, 6, 8)), 8, 64
  elif name == "sx 1024":  # blocks of 97 x 5 pixels, across span seams
    y, x = np.divmod(np.arange(16 * 1024), 1024)
    labels = (x // 97 + 3 * (y // 5)) % 6
    cc, sx, sy = paint(np.stack([labels, labels[::-1]]).reshape(
      2, 16, 1024)), 1024, 16
  elif name == "two-colour checkerboard":  # every pixel its own run
    y, x = np.divmod(np.arange(64 * 64), 64)
    cc, sx, sy = torch.from_numpy(((x + y) % 2)[None].astype(np.int32)), 64, 64
  elif name == "cap_n 4096":  # 4096 singletons, and noise past cap_n
    rng = np.random.RandomState(11)
    cc = torch.from_numpy(np.stack([
      rng.permutation(4096), rng.randint(-5, 4100, 4096)]).astype(np.int32))
    sx, sy = 64, 64
    return cc, sx, sy, 4096
  else:
    raise KeyError(name)
  return cc, sx, sy, ccl._pow2_cap(int(cc.max()) + 1)


STATS_EDGES = ["band seams", "checkerboard", "one component", "sx 8",
               "sx 1024", "two-colour checkerboard", "cap_n 4096"]


@pytest.mark.parametrize("name", ["checkerboard", "band seams"])
def test_slice_stats_edges_match_pallas(interpret, name):
  """The plain version, which the kernel is held to on the card, against
  the reference on a slice of singletons and on the band-seam shape."""
  _hold_to_pallas(*stats_edge_case(name))


def test_slice_stats_plain_against_numpy():
  """Ids outside [0, cap_n) are not counted; empty components read
  count 0, mins EMPTY_MIN and maxes -1."""
  rng = np.random.RandomState(4)
  B, sy, sx, cap_n = 2, 5, 7, 16
  cc = rng.randint(-2, cap_n + 3, (B, sy * sx)).astype(np.int32)
  got = stats.slice_stats(torch.from_numpy(cc), sx, sy, cap_n).numpy()
  for b in range(B):
    for k in range(cap_n):
      ys, xs = np.divmod(np.flatnonzero(cc[b] == k), sx)
      empty = len(xs) == 0
      want = [len(xs), xs.sum(), ys.sum(),
              stats.EMPTY_MIN if empty else xs.min(),
              -1 if empty else xs.max(),
              stats.EMPTY_MIN if empty else ys.min(),
              -1 if empty else ys.max(), 0]
      np.testing.assert_array_equal(got[b, k], want)


def test_slice_stats_rejects_bad_inputs():
  cc = torch.zeros((2, 12), dtype=torch.int32)
  with pytest.raises(ValueError):
    stats.slice_stats(cc.to(torch.int64), 4, 3, 8)
  with pytest.raises(ValueError):
    stats.slice_stats(cc, 4, 4, 8)
  with pytest.raises(ValueError):
    stats.slice_stats(cc, 4, 3, stats.MAX_CAP_N + 1)


@pytest.mark.parametrize("sx,sy,cap_n,want", [
  (40, 24, 8, True), (40, 20, 8, False), (2048, 8, 8, False),
  (4, 8, 8, False), (512, 512, 1024, True), (512, 512, 8192, False)])
def test_eligible_matches_reference(sx, sy, cap_n, want):
  assert stats.eligible(sx, sy, cap_n) == want
  assert stats_pallas.eligible(sx, sy, cap_n) == want


def _host(monkeypatch, binary):
  monkeypatch.setattr(A, "_use_device_stats", lambda: False)
  return (A.voxel_counts(binary), A.centroids(binary),
          A.bounding_boxes(binary, no_slice_conversion=True))


def _same(got, want):
  vc, cen, bb = got
  vc_w, cen_w, bb_w = want
  assert vc == vc_w
  assert set(cen) == set(cen_w)
  for k in cen_w:
    np.testing.assert_allclose(cen[k], cen_w[k], rtol=1e-12)
  assert set(bb) == set(bb_w)
  for k in bb_w:
    assert bb[k].dtype == np.uint32
    np.testing.assert_array_equal(bb[k], bb_w[k])


def _port(binary):
  return (ct.voxel_counts(binary, device="cpu"),
          ct.centroids(binary, device="cpu"),
          ct.bounding_boxes(binary, no_slice_conversion=True, device="cpu"))


def test_analytics_match_reference(interpret, monkeypatch):
  """Mirrors test_analytics.test_device_stats_match_host: the port's
  device path equals the reference's device path and its host loop."""
  binary = crackle.compress(random_volume((40, 24, 6), 7, 51, 5))
  got = _port(binary)
  _same(got, (A.voxel_counts(binary), A.centroids(binary),
              A.bounding_boxes(binary, no_slice_conversion=True)))
  _same(got, _host(monkeypatch, binary))


def test_analytics_windows_of_256(monkeypatch):
  """Windows of 2 slices (the port's 256, shrunk) aggregate to the
  same answer as one."""
  from crackle_tpu_torch.ops import analytics as TA
  binary = crackle.compress(random_volume((16, 8, 5), 5, 3, 4))
  whole = _port(binary)
  monkeypatch.setattr(TA, "_DEVICE_WINDOW", 2)
  _same(_port(binary), whole)
  _same(whole, _host(monkeypatch, binary))


def test_analytics_host_loop_where_the_reference_takes_it(monkeypatch,
                                                          caplog):
  """Pins streams, a label= query and shapes the stats kernel does not
  take go to the host loop, with the reason logged, and equal it."""
  caplog.set_level(logging.WARNING, "crackle_tpu_torch.analytics")
  pins = crackle.compress(pins_volume(), allow_pins=1)
  odd = crackle.compress(random_volume((12, 7, 3), 4, 8, 3))
  assert not stats.eligible(12, 7, 8)
  for binary in (pins, odd):
    _same(_port(binary), _host(monkeypatch, binary))
  assert "FLAT" in caplog.text and "ineligible" in caplog.text

  vol = random_volume((16, 8, 4), 5, 2, 3)
  binary = crackle.compress(vol)
  lbl = int(vol[3, 3, 2])
  assert ct.voxel_counts(binary, label=lbl, device="cpu") == \
    int((vol == lbl).sum())
  assert ct.voxel_counts(binary, label=lbl, device="cpu") == \
    A.voxel_counts(binary, label=lbl)
  np.testing.assert_array_equal(
    ct.bounding_boxes(binary, label=lbl, no_slice_conversion=True,
                      device="cpu"),
    A.bounding_boxes(binary, label=lbl, no_slice_conversion=True))
  assert ct.bounding_boxes(binary, label=lbl, device="cpu") == \
    A.bounding_boxes(binary, label=lbl)
  np.testing.assert_allclose(ct.centroids(binary, label=lbl, device="cpu"),
                             A.centroids(binary, label=lbl), rtol=1e-12)
  assert "single label" in caplog.text
  with pytest.raises(ValueError, match="not contained"):
    ct.voxel_counts(binary, label=10 ** 6, device="cpu")


def test_analytics_single_label_shortcuts():
  vol = np.full((9, 8, 3), 7, np.uint32, order="F")
  binary = crackle.compress(vol)
  assert ct.voxel_counts(binary, device="cpu") == {7: 9 * 8 * 3}
  np.testing.assert_array_equal(
    ct.bounding_boxes(binary, no_slice_conversion=True, device="cpu")[7],
    [0, 0, 0, 8, 7, 2])
  assert ct.centroids(binary, device="cpu") == {7: (4.0, 3.5, 1.0)}


def test_device_array_analytics(interpret):
  """CrackleDeviceArray's analytics go through the port's and equal
  the reference facade's."""
  vol = random_volume((24, 16, 4), 6, 12, 4)
  binary = crackle.compress(vol)
  arr = ct.CrackleDeviceArray(binary, "cpu")
  ref = crackle.CrackleDeviceArray(binary)
  assert arr.voxel_counts() == ref.voxel_counts()
  assert arr.bounding_boxes() == ref.bounding_boxes()
  for k, v in ref.centroids().items():
    np.testing.assert_allclose(arr.centroids()[k], v, rtol=1e-12)
  got, want = arr.point_cloud(), ref.point_cloud()
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k])


def test_slice_stats_exact_past_2_24():
  """The reference's f32 sums round past 2^24: on this 512^2 slice
  stats_pallas gives component 0 an x-sum of 66,977,792.0 (interpret
  mode). The port's int64 sums give the exact 66,977,791."""
  cc = torch.zeros((1, 512 * 512), dtype=torch.int32)
  cc[0, 1] = 1
  got = stats.slice_stats(cc, 512, 512, 8)[0]
  assert got[0, :3].tolist() == [512 * 512 - 1, 66_977_791, 66_977_792]
  assert got[1].tolist() == [1, 1, 0, 1, 1, 0, 0, 0]
