"""Per-slice 4-connected connected-components labeling.

Reference parity: src/cc3d.hpp. The format requires a very specific
numbering: components are numbered 0..N-1 by the raster order (x fastest,
then y) of their first-visited voxel. The stored keys and the per-slice
crack CRCs both depend on this numbering, so it is normative.

The reference uses a sequential two-pass union-find raster scan. Here we
use a data-parallel formulation (edge list -> union-find via
scipy.sparse.csgraph on host) followed by a first-visit renumbering
pass, which provably produces the identical labeling.

All functions operate on flat 1D arrays in x-fastest order (the format's
native order for a Fortran-ordered (sx, sy) slice).
"""
import numpy as np
from scipy import sparse
from scipy.sparse import csgraph


def first_visit_renumber(comp: np.ndarray, num: int, dtype=np.uint32):
  """Renumber arbitrary component ids 0..num-1 to first-visit raster order.

  Returns (renumbered array, num_components).
  """
  if comp.size == 0:
    return comp.astype(dtype), 0
  # first occurrence index of each component id (np.unique scans in order
  # and returns the first index of each sorted-unique value)
  uniq, first_idx = np.unique(comp, return_index=True)
  # rank components by their first occurrence
  order = np.argsort(first_idx, kind='stable')
  rank = np.empty(len(uniq), dtype=dtype)
  rank[order] = np.arange(len(uniq), dtype=dtype)
  return rank[comp], len(uniq)


def _components_from_edges(n: int, ei: np.ndarray, ej: np.ndarray):
  """Union-find over n nodes with undirected edges (ei, ej)."""
  if len(ei) == 0:
    return np.arange(n, dtype=np.int64), n
  g = sparse.coo_matrix(
    (np.ones(len(ei), dtype=bool), (ei, ej)), shape=(n, n)
  ).tocsr()
  ncomp, comp = csgraph.connected_components(g, directed=False)
  return comp, ncomp


def connected_components_slice(labels_flat: np.ndarray, sx: int, sy: int,
                               dtype=np.uint32):
  """4-connected CCL of one slice given as a flat x-fastest label array.

  Returns (cc_labels flat uint32 numbered by first raster visit, N).
  Parity: cc3d::connected_components2d_4 (cc3d.hpp:257-369) + relabel.
  """
  n = sx * sy
  if n == 0:
    return labels_flat.astype(dtype), 0
  from .. import native
  res = native.ccl_slice(labels_flat, sx, sy)
  if res is not None:
    cc, N = res
    return cc.astype(dtype, copy=False), N
  a = labels_flat
  idx = np.arange(n, dtype=np.int64)
  # horizontal edges: i ~ i-1 when x > 0 and labels equal
  hmask = (idx % sx > 0)
  hmask &= np.concatenate([[False], a[1:] == a[:-1]])
  # vertical edges: i ~ i-sx when y > 0 and labels equal
  vmask = idx >= sx
  vmask[sx:] &= (a[sx:] == a[:-sx])
  ei = np.concatenate([idx[hmask], idx[vmask]])
  ej = np.concatenate([idx[hmask] - 1, idx[vmask] - sx])
  comp, _ = _components_from_edges(n, ei, ej)
  return first_visit_renumber(comp, n, dtype=dtype)


def color_connectivity_graph_slice(vcg_flat: np.ndarray, sx: int, sy: int,
                                   dtype=np.uint32):
  """4-connected CCL of one slice from a voxel connectivity graph.

  vcg bits (LSB first): 0 = +x passable, 1 = -x passable,
  2 = +y passable, 3 = -y passable.
  Parity: cc3d::color_connectivity_graph (cc3d.hpp:146-254). Only the
  -x (bit 1) and -y (bit 3) bits are consulted, like the reference.
  """
  n = sx * sy
  if n == 0:
    return vcg_flat.astype(dtype), 0
  from .. import native
  res = native.ccl_vcg_slice(vcg_flat, sx, sy)
  if res is not None:
    cc, N = res
    return cc.astype(dtype, copy=False), N
  idx = np.arange(n, dtype=np.int64)
  hmask = (idx % sx > 0) & ((vcg_flat & 0b0010) > 0)
  vmask = (idx >= sx) & ((vcg_flat & 0b1000) > 0)
  ei = np.concatenate([idx[hmask], idx[vmask]])
  ej = np.concatenate([idx[hmask] - 1, idx[vmask] - sx])
  comp, _ = _components_from_edges(n, ei, ej)
  return first_visit_renumber(comp, n, dtype=dtype)


def connected_components(labels: np.ndarray, sx: int, sy: int, sz: int,
                         dtype=np.uint32):
  """Volume-wide slicewise CCL with a running label offset.

  labels: flat array in x-fastest, then y, then z order (F-order ravel).
  Returns (cc_labels flat, num_components_per_slice list, N_total).
  Parity: cc3d::connected_components (cc3d.hpp:371-400).
  """
  sxy = sx * sy
  out = np.zeros(sxy * sz, dtype=dtype)
  num_per_slice = np.zeros(sz, dtype=np.uint64)
  start = 0
  for z in range(sz):
    cc, n = connected_components_slice(labels[z * sxy:(z + 1) * sxy], sx, sy,
                                       dtype=dtype)
    out[z * sxy:(z + 1) * sxy] = cc + dtype(start)
    num_per_slice[z] = n
    start += n
  return out, num_per_slice, start
