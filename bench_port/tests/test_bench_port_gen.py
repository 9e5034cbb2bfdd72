"""The volume generators: exact nearest seeds, and the same volume for
the same seed."""
import numpy as np
import pytest
import torch

from bench_port.gen import connectomics, voronoi, watershed

SHAPE = (40, 28, 12)


def brute(pts, shape, aniso):
  sx, sy, sz = shape
  zs, ys, xs = np.meshgrid(np.arange(sz), np.arange(sy), np.arange(sx),
                           indexing="ij")
  q = np.stack([xs, ys, zs], -1).reshape(-1, 3) * [1, 1, aniso]
  p = pts.numpy().astype(np.float64) * [1, 1, aniso]
  d = ((q[:, None, :] - p[None]) ** 2).sum(-1)
  return d.min(1), d


@pytest.mark.parametrize("cell", [(8, 8, 6), (5, 4, 3), (40, 28, 12)])
@pytest.mark.parametrize("n", [1, 9, 60])
def test_nearest_seed_is_nearest(cell, n):
  pts = voronoi.uniform(voronoi.generator(n, "cpu"), n, SHAPE, "cpu")
  got = voronoi.nearest_seed(pts, SHAPE, 0.35, cell).reshape(-1).numpy()
  best, d = brute(pts, SHAPE, 0.35)
  np.testing.assert_allclose(d[np.arange(len(got)), got], best, rtol=1e-5,
                             atol=1e-3)


@pytest.mark.parametrize("mod", [connectomics, watershed])
def test_same_seed_same_volume(mod):
  big = (1 << 31) + 12345
  a = mod.make(SHAPE, big, "cpu")
  b = mod.make(SHAPE, big, "cpu")
  c = mod.make(SHAPE, big + 1, "cpu")
  assert a.shape == (SHAPE[2], SHAPE[1], SHAPE[0])
  assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
  assert not torch.equal(a.view(torch.uint8), c.view(torch.uint8))


def test_label_ranges():
  c = connectomics.make(SHAPE, 3, "cpu").view(torch.int32)
  assert c.dtype == torch.int32 and int(c.min()) >= 1
  w = watershed.make(SHAPE, 3, "cpu").view(torch.int64)
  assert int(w.min()) >= (1 << 40) + 1
  assert int(w.max()) < (1 << 40) + 1 + max(
    SHAPE[0] * SHAPE[1] * SHAPE[2] // watershed.VOXELS_PER_SEED, 10)
