"""The paint_vcg and plant plain versions at the seams of their kernels'
grids: slices 1, 31, 511, 513 and 2049 wide, painted whole, in bands
that hold whole rows and in bands narrower than a row (split H ranges),
against a numpy oracle and the JAX replay; and plant against the
Pallas plant in interpret mode and a numpy oracle on ids at -1, at n,
equal to the padding root, repeated roots and tables past one block's
shared memory."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import crackle_tpu as crackle
from crackle_tpu.kernels import ccl_pallas
from crackle_tpu_torch.kernels import ccl, replay

from test_jax_decode import random_volume
from test_torch_ccl import labels_to_vcg, smooth_labels
from test_torch_replay import check_against_xla

# (sx, sy) of the seam widths: sy keeps each slice at a few thousand
# pixels, so the kernel's grid takes several bands at B = 1
SEAMS = [(1, 4099), (31, 97), (511, 9), (513, 7), (2049, 3)]
H100_SMS = 132


def numpy_vcg(ids, sx, sy, permissible):
  """The 4-bit VCG from edge ids, one slice a row of ids: V[y, x+1] |
  V[y, x] << 1 | H[y+1, x] << 2 | H[y, x] << 3."""
  NV = sy * (sx + 1)
  NB = NV + (sy + 1) * sx
  out = []
  for row in ids:
    e = row[(row >= 0) & (row < NB)].astype(np.int64)
    V = np.zeros(NV, np.int32)
    H = np.zeros(NB - NV, np.int32)
    V[e[e < NV]] = 1
    H[e[e >= NV] - NV] = 1
    V = V.reshape(sy, sx + 1)
    H = H.reshape(sy + 1, sx)
    out.append(V[:, 1:] | (V[:, :-1] << 1) | (H[1:] << 2) | (H[:-1] << 3))
  vcg = np.stack(out)
  return vcg if permissible else vcg ^ 0b1111


def seam_ids(sx, sy, seed):
  """Rows of edge ids: every edge of the slice, none, random ones with
  ids out of range, and a sparse set in a random order."""
  NB = sy * (sx + 1) + (sy + 1) * sx
  rng = np.random.RandomState(seed)
  sparse = np.where(rng.rand(NB) < 0.05, rng.randint(0, NB, NB), -1)
  return np.stack([np.arange(NB), np.full(NB, -1),
                   rng.randint(-5, NB + 5, NB),
                   rng.permutation(sparse)]).astype(np.int32)


def band_smem(layout, sx, sy):
  """PAINT_SMEM_MAX for a layout: the whole slice, bands of a few rows
  (one H range), or bands under a row (split H ranges)."""
  if layout == "whole":
    return replay.PAINT_SMEM_MAX
  n = sx * sy
  rows = 32 * -(-min(max(sx * min(3, sy - 1), 512), n // 2) // 32)
  P = 32 * max(1, sx // 64) if layout == "split" else rows
  return 4 * replay._band_words(P, sx)


LAYOUTS = [(sx, sy, layout) for sx, sy in SEAMS
           for layout in ("whole", "rows", "split") if layout != "split"
           or sx >= 64]


@pytest.mark.parametrize("sx,sy,layout", LAYOUTS)
def test_paint_vcg_plain_seams_match_numpy(monkeypatch, sx, sy, layout):
  monkeypatch.setattr(replay, "PAINT_SMEM_MAX", band_smem(layout, sx, sy))
  P = replay.paint_band_px(sx, sy)
  assert (P == sx * sy) == (layout == "whole")
  assert replay._band_layout(P, sx)[2] == (layout == "split")
  ids = seam_ids(sx, sy, sx + sy)
  for perm in (True, False):
    got = replay.paint_vcg(torch.from_numpy(ids), sx, sy, perm)
    np.testing.assert_array_equal(got.numpy(),
                                  numpy_vcg(ids, sx, sy, perm))


@pytest.mark.parametrize("sx,sy,layout", [
  (sx, 97 if sx == 1 else min(sy, 7), layout) for sx, sy, layout in LAYOUTS
  if layout != "whole"])
def test_replay_in_bands_matches_xla_at_seams(monkeypatch, sx, sy, layout):
  """The port's VCG, its paint walking bands of the kernel's layouts,
  against the JAX replay of the same stream."""
  monkeypatch.setattr(replay, "PAINT_SMEM_MAX", band_smem(layout, sx, sy))
  assert replay.paint_band_px(sx, sy) < sx * sy
  check_against_xla(crackle.compress(random_volume((sx, sy, 2), 5,
                                                   sx + sy, 3)))


@pytest.mark.parametrize("B", [1, 2, 32, 512])
@pytest.mark.parametrize("sx,sy", SEAMS + [(512, 512), (2048, 2048)])
def test_paint_grid_covers_each_slice(B, sx, sy):
  """paint_grid's bands tile each slice, none past paint_band_px; where
  that bound does not set them, there are at least 32/33 of the bands
  wanted (at most PAINT_FILL blocks an SM and one a PAINT_MIN_BAND
  pixels), from one to PAINT_FILL blocks an SM where the fill sets
  them, and more bands than slices at B = 1."""
  n = sx * sy
  bands, P = replay.paint_grid(B, sx, sy, H100_SMS)
  assert (bands - 1) * P < n <= bands * P
  assert P <= replay.paint_band_px(sx, sy)
  assert P == n or P % 32 == 0
  fill = replay.PAINT_FILL * H100_SMS // B
  want = max(1, min(fill, -(-n // replay.PAINT_MIN_BAND)))
  if P < replay.paint_band_px(sx, sy):
    assert 33 * bands >= 32 * want
    assert P >= min(n, replay.PAINT_MIN_BAND // 2)
    if want == fill:
      assert H100_SMS <= bands * B <= replay.PAINT_FILL * H100_SMS
  if B == 1 and n >= 2 * replay.PAINT_MIN_BAND:
    assert bands > B


def test_paint_grid_at_the_path_shapes():
  """One block an SM or more at B = 32 and at B = 1 on 512^2 slices."""
  for B in (1, 32):
    bands, _ = replay.paint_grid(B, 512, 512, H100_SMS)
    assert bands * B >= H100_SMS and bands > 1
  assert replay.paint_grid(512, 512, 512, H100_SMS)[0] == 1


@pytest.mark.parametrize("B,n", [(1, 262144), (32, 262144), (512, 262144),
                                 (3, 37 * 29), (1, 7), (2, 4099)])
def test_plant_span_covers_each_slice(B, n):
  span = ccl.plant_span(B, n, H100_SMS)
  blocks = -(-n // span)
  assert span % 4 == 0 and (blocks - 1) * span < n
  assert blocks * B >= ccl.PLANT_FILL * H100_SMS or \
      span <= ccl.PLANT_MIN_SPAN + 3


def numpy_plant(L, roots, T):
  """cc = the first k with roots[k] == L[p], painted = T[:, k], where L[p]
  lies in [0, n) and the roots hold it; 0 elsewhere."""
  B = L.shape[0]
  n = L[0].size
  K = 0 if T is None else T.shape[1]
  cc = np.zeros((B, n), np.int32)
  painted = np.zeros((B, K, n), np.int32)
  for b in range(B):
    first = {}
    for k, v in enumerate(roots[b].tolist()):
      if 0 <= v < n:
        first.setdefault(v, k)
    for p, v in enumerate(L[b].reshape(-1).tolist()):
      if v in first:
        cc[b, p] = first[v]
        painted[b, :, p] = T[b, :, first[v]] if K else 0
  return cc, painted


@pytest.mark.parametrize("K", [0, 1, 2])
@pytest.mark.parametrize("sx,sy", [(1, 97), (31, 9), (511, 3), (513, 3),
                                   (2049, 2)])
def test_plant_plain_seams_match_pallas_interpret(monkeypatch, sx, sy, K):
  """ccl_min's L of a seam-wide slice and its roots: the plain plant
  against the Pallas plant in interpret mode and the numpy oracle."""
  monkeypatch.setattr(ccl_pallas, "INTERPRET", True)
  B, cap_n = 2, 1024
  rng = np.random.RandomState(sx + K)
  vcg = labels_to_vcg(smooth_labels(B, sy, sx, 4, sx, rounds=6))
  L, tgt = ccl.ccl_min_plain(torch.from_numpy(vcg))
  roots, _ = ccl.roots_from_tgt(tgt, cap_n)
  T = rng.randint(-(1 << 31), 1 << 31, size=(B, K, cap_n),
                  dtype=np.int64).astype(np.int32)
  cc, painted = ccl.plant(L, roots, torch.from_numpy(T) if K else None)
  want_cc, want_p = ccl_pallas.plant_traced(
    jnp.asarray(L.numpy()), jnp.asarray(roots.numpy()), jnp.asarray(T),
    sx, sy)
  np.testing.assert_array_equal(cc.numpy(), np.asarray(want_cc))
  np.testing.assert_array_equal(painted.numpy(), np.asarray(want_p))
  for got, want in zip((cc, painted), numpy_plant(
      L.numpy(), roots.numpy(), T if K else None)):
    np.testing.assert_array_equal(got.numpy(), want)


def edge_plant_inputs(B, sy, sx, cap_n, K, seed):
  """L with ids at -1, at n (the padding root), past n, non-roots and
  roots; sorted roots with repeats, padded with n from 3/4 of cap_n on;
  random tables."""
  n = sy * sx
  rng = np.random.RandomState(seed)
  roots = np.sort(rng.choice(n, (B, cap_n)), 1).astype(np.int32)
  roots[:, 3 * cap_n // 4:] = n
  L = rng.randint(-3, n + 3, (B, n))
  hits = rng.rand(B, n) < 0.5
  L[hits] = roots[np.nonzero(hits)[0],
                  rng.randint(0, 3 * cap_n // 4, int(hits.sum()))]
  L[:, :3] = [-1, n, n + 1]
  T = rng.randint(-(1 << 31), 1 << 31, size=(B, K, cap_n),
                  dtype=np.int64).astype(np.int32) if K else None
  return L.astype(np.int32).reshape(B, sy, sx), roots, T


@pytest.mark.parametrize("K", [0, 1, 2])
@pytest.mark.parametrize("sy,sx,cap_n", [
  (33, 65, 256), (16, 64, 4096), (256, 512, 65536), (1, 7, 8)])
def test_plant_plain_edge_ids_match_numpy(sy, sx, cap_n, K):
  """Ids at -1, at n and past it, equal to the padding root, repeated
  roots, and tables past PAINT_CAP_N and past one block's shared memory
  (65536 roots): plant's plain version against the numpy oracle."""
  L, roots, T = edge_plant_inputs(2, sy, sx, cap_n, K, sy + sx + K)
  cc, painted = ccl.plant(torch.from_numpy(L), torch.from_numpy(roots),
                          torch.from_numpy(T) if K else None)
  want_cc, want_p = numpy_plant(L, roots, T)
  np.testing.assert_array_equal(cc.numpy(), want_cc)
  np.testing.assert_array_equal(painted.numpy(), want_p)
  assert int((want_cc > 0).sum()) > 0
