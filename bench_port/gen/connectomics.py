"""The connectomics volume of a configuration, made on the device from a
seed.

A copy, in PyTorch, of bench.py's synthetic_connectomics (bench.py:40-85):
a two-scale anisotropic Voronoi labelling, a sparse backbone of large
z-elongated cells plus dense patches of small fragments, calibrated to
the published compression profile of upstream crackle's
connectomics.npy (0.56% flat, benchmarks/README.md:10-14). The seeds
come from torch's generator on the device, so a seed gives the same
volume on the same device, not the volume bench.py's numpy generator
gives.
"""
import torch

from . import voronoi

# densities per 4.19M voxels (256 * 256 * 64), scaled by volume
# (bench.py:49-53)
SPARSE_PER_4M = 16
PATCHES_PER_4M = 2
PER_PATCH = 40
PATCH_SIGMA = 10.0
ANISO_Z = 0.35
# seed bins of about a backbone cell's size; the dense patches make the
# backbone's wide gaps the rarer case, so the exact fallback stays small
CELL = (32, 32, 96)


def make(shape, seed: int, device):
  """(sz, sy, sx) uint32 labels 1..P, x fastest."""
  sx, sy, sz = shape
  g = voronoi.generator(seed, device)
  scale = (sx * sy * sz) / (256 * 256 * 64)
  n_sparse = max(int(round(SPARSE_PER_4M * scale)), 2)
  n_patches = max(int(round(PATCHES_PER_4M * scale)), 1)
  dims = torch.tensor([sx, sy, sz], dtype=torch.float32, device=device)
  sparse = voronoi.uniform(g, n_sparse, (sx, sy, sz), device)
  centers = voronoi.uniform(g, n_patches, (sx, sy, sz), device)
  spread = torch.tensor([1.0, 1.0, 1.0 / ANISO_Z], device=device)
  patch = (centers[:, None, :] + torch.randn(
    (n_patches, PER_PATCH, 3), generator=g, device=device)
    * PATCH_SIGMA * spread).reshape(-1, 3)
  pts = torch.minimum(torch.cat([sparse, patch]).clamp(min=0), dims - 1)
  cell = tuple(min(c, s) for c, s in zip(CELL, shape))
  idx = voronoi.nearest_seed(pts, shape, ANISO_Z, cell)
  return (idx + 1).to(torch.int32).view(torch.uint32)
