"""Exact nearest-seed labelling of a voxel grid under an anisotropic
metric, on any torch device.

The two volume generators label every voxel with its nearest seed under
the distance sqrt(dx^2 + dy^2 + (aniso * dz)^2), as scipy's cKDTree
query over scaled coordinates does in the generators they copy. Here the
seeds are binned into cells of `cell` voxels; each cell's voxels are
compared with the seeds of the 3 x 3 x 3 cells around it, which is exact
for every voxel whose nearest candidate lies closer than the edge of
that neighbourhood. The few voxels where it does not are compared with
every seed.
"""
import torch

# voxel-candidate distances held at once (float32 elements)
_CHUNK_ELEMS = 1 << 28


def _scaled(t, aniso: float):
  return t * torch.tensor([1.0, 1.0, aniso], dtype=t.dtype, device=t.device)


def _sqdist(a, b):
  """Squared distances of broadcast points a and b (..., 3), an axis
  at a time so that no (..., 3) difference is held."""
  return ((a[..., 0] - b[..., 0]) ** 2 + (a[..., 1] - b[..., 1]) ** 2
          + (a[..., 2] - b[..., 2]) ** 2)


def _brute(q, pts_s, out_dtype=torch.int64):
  """Index of the nearest seed of each scaled query q (n, 3) among all
  scaled seeds pts_s (P, 3)."""
  out = torch.empty(q.shape[0], dtype=out_dtype, device=q.device)
  step = max(1, _CHUNK_ELEMS // max(pts_s.shape[0], 1))
  for i in range(0, q.shape[0], step):
    out[i:i + step] = _sqdist(q[i:i + step, None, :], pts_s[None]).argmin(1)
  return out


def nearest_seed(points, shape, aniso: float, cell):
  """points (P, 3) float32 (x, y, z) voxel coordinates on the target
  device; shape (sx, sy, sz); cell (cx, cy, cz) voxels a bin. Returns
  the (sz, sy, sx) int64 index of each voxel's nearest point."""
  dev = points.device
  sx, sy, sz = shape
  cx, cy, cz = cell
  ncx, ncy, ncz = -(-sx // cx), -(-sy // cy), -(-sz // cz)
  P = points.shape[0]
  pts_s = _scaled(points, aniso)

  ci = torch.stack([
    (points[:, 0] // cx).clamp(0, ncx - 1),
    (points[:, 1] // cy).clamp(0, ncy - 1),
    (points[:, 2] // cz).clamp(0, ncz - 1)], 1).to(torch.int64)
  cid = ci[:, 0] + ncx * (ci[:, 1] + ncy * ci[:, 2])
  order = torch.argsort(cid, stable=True)
  ncell = ncx * ncy * ncz
  counts = torch.bincount(cid, minlength=ncell)
  starts = torch.cumsum(counts, 0) - counts

  # each cell's 27 neighbours (-1 outside the grid)
  g = torch.arange(ncell, device=dev)
  gx, gy, gz = g % ncx, (g // ncx) % ncy, g // (ncx * ncy)
  off = torch.tensor([(a, b, c) for c in (-1, 0, 1) for b in (-1, 0, 1)
                      for a in (-1, 0, 1)], device=dev)
  nx = gx[:, None] + off[None, :, 0]
  ny = gy[:, None] + off[None, :, 1]
  nz = gz[:, None] + off[None, :, 2]
  inside = ((nx >= 0) & (nx < ncx) & (ny >= 0) & (ny < ncy) & (nz >= 0)
            & (nz < ncz))
  nbr = torch.where(inside, nx + ncx * (ny + ncy * nz), 0)
  ncnt = torch.where(inside, counts[nbr], 0)
  nst = starts[nbr]
  ncum = torch.cumsum(ncnt, 1)
  L = ncum[:, -1]

  out = torch.empty((sz, sy, sx), dtype=torch.int64, device=dev)
  # voxel offsets inside a cell
  lz, ly, lx = torch.meshgrid(torch.arange(cz, device=dev),
                              torch.arange(cy, device=dev),
                              torch.arange(cx, device=dev), indexing="ij")
  loc = torch.stack([lx.reshape(-1), ly.reshape(-1), lz.reshape(-1)], 1)
  V = loc.shape[0]
  w = torch.tensor([1.0, 1.0, aniso], device=dev)
  size = torch.tensor([cx, cy, cz], device=dev)
  ncs = torch.tensor([ncx, ncy, ncz], device=dev)
  dims = torch.tensor([sx, sy, sz], device=dev)

  # cells from the longest candidate list down, so that a chunk pads
  # little and its first cell sets its width
  by_len = torch.argsort(L, descending=True, stable=True)
  Lh = L[by_len].tolist()
  i = 0
  misses = []
  while i < ncell:
    lmax = max(Lh[i], 1)
    j = min(i + max(1, _CHUNK_ELEMS // (V * lmax)), ncell)
    cells = by_len[i:j]
    # candidate seed of each slot (sorted-order index -> original)
    s = torch.arange(lmax, device=dev).expand(len(cells), lmax)
    cum = ncum[cells]
    k = torch.searchsorted(cum, s.contiguous(), right=True).clamp(max=26)
    cnt_k = torch.gather(ncnt[cells], 1, k)
    within = s - (torch.gather(cum, 1, k) - cnt_k)
    valid = s < L[cells][:, None]
    idx = order[(torch.gather(nst[cells], 1, k) + within).clamp(0, P - 1)]
    cand = pts_s[idx]                                  # (nb, lmax, 3)
    org = torch.stack([gx[cells] * cx, gy[cells] * cy, gz[cells] * cz], 1)
    vox = org[:, None, :] + loc[None]                  # (nb, V, 3)
    q = _scaled(vox.to(torch.float32), aniso)
    d = _sqdist(q[:, :, None, :], cand[:, None, :, :])
    d = torch.where(valid[:, None, :], d, torch.inf)
    best, arg = d.min(2)
    nearest = torch.gather(idx, 1, arg)                # (nb, V)
    # distance from each voxel to the edge of its neighbourhood; no
    # seed lies past a side that is the grid's edge
    cell_idx = torch.stack([gx[cells], gy[cells], gz[cells]], 1)
    lo = ((cell_idx - 1) * size).to(torch.float32)
    hi = ((cell_idx + 2) * size).to(torch.float32)
    vf = vox.to(torch.float32)
    to_lo = torch.where((cell_idx[:, None, :] - 1) >= 0, vf - lo[:, None],
                        torch.inf)
    to_hi = torch.where((cell_idx[:, None, :] + 2) < ncs, hi[:, None] - vf,
                        torch.inf)
    margin = (torch.minimum(to_lo, to_hi) * w).amin(-1)
    ok = best < margin ** 2
    keep = (vox < dims).all(-1)
    vz, vy, vx = vox[..., 2], vox[..., 1], vox[..., 0]
    sel = keep & ok
    out[vz[sel], vy[sel], vx[sel]] = nearest[sel]
    miss = keep & ~ok
    if bool(miss.any()):
      misses.append(vox[miss])
    i = j
  if misses:
    m = torch.cat(misses)
    out[m[:, 2], m[:, 1], m[:, 0]] = _brute(
      _scaled(m.to(torch.float32), aniso), pts_s)
  return out


def uniform(gen, n: int, dims, device):
  """n points uniform in [0, dims) per axis, float32 (x, y, z)."""
  d = torch.tensor(dims, dtype=torch.float32, device=device)
  return torch.rand((n, 3), generator=gen, device=device) * d


def generator(seed: int, device):
  """A torch.Generator on `device` seeded from any whole number."""
  g = torch.Generator(device=device)
  g.manual_seed(int(seed) % (1 << 63))
  return g
