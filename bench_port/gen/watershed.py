"""The watershed over-segmentation of a configuration, made on the
device from a seed.

A copy, in PyTorch, of benchmarks/perf.py's watershed_like
(benchmarks/perf.py:28-43), tuned to the ~1.65% compressed profile of
upstream crackle's ws.npy: a dense uniform anisotropic Voronoi
labelling, one seed per ~2000 voxels, u64 labels offset past 2^40.
"""
import torch

from . import voronoi

VOXELS_PER_SEED = 2000
ANISO_Z = 0.35
LABEL_OFFSET = (1 << 40) + 1
CELL = (16, 16, 48)


def make(shape, seed: int, device):
  """(sz, sy, sx) uint64 labels, x fastest."""
  sx, sy, sz = shape
  g = voronoi.generator(seed, device)
  n = max(sx * sy * sz // VOXELS_PER_SEED, 10)
  pts = voronoi.uniform(g, n, (sx, sy, sz), device)
  cell = tuple(min(c, s) for c, s in zip(CELL, shape))
  idx = voronoi.nearest_seed(pts, shape, ANISO_Z, cell)
  return (idx + LABEL_OFFSET).view(torch.uint64)
