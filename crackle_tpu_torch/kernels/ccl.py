"""Per-slice 4-connected CCL with first-visit numbering and label paint.

Counterpart of crackle_tpu/kernels/ccl_pallas.py: ccl_batch_traced and
ccl_paint_traced (``ccl_paint``), and the v2 split ccl_min_traced,
roots_from_tgt and plant_traced (``ccl_min``, ``roots_from_tgt``,
``plant``; ``ccl_min_roots`` is the first two in one launch). The CCL
kernels (csrc/ccl.cu) run a union-find with union by min, first inside
tiles of TILE_PIX consecutive raster pixels in shared memory, then
across the tiles' seams in device memory; the plain
versions below follow decode._ccl_batch: alternating row/column
segmented-min sweeps to a fixed point, then the first-visit renumber,
plus the table paint.
"""
import torch

from . import _build

# largest per-slice paint table (ccl_pallas.PAINT_CAP_N)
PAINT_CAP_N = 2048

# blocks of the plant kernel wanted on each SM, and the fewest pixels a
# block takes: a slice is cut into min(n / PLANT_MIN_SPAN, PLANT_FILL x
# SMs / B) spans of pixels, one block each
PLANT_FILL = 4
PLANT_MIN_SPAN = 1024

# consecutive raster pixels per tile of the CCL kernels: the shared-
# memory forest of one block; a power of two in [32, 8192]. Tests shrink
# it to cross tile seams.
TILE_PIX = 8192


def _seg_min(L, blocked, dim):
  """Segmented inclusive min scan along dim; a segment starts where
  `blocked` is set. Segment ids grow along the scan, so one cummax of
  seg * BIG - L is the running minimum within each segment."""
  big = L.shape[1] * L.shape[2] + 1
  seg = torch.cumsum(blocked.to(torch.int64), dim)
  return seg * big - torch.cummax(seg * big - L, dim).values


def _min_image(vcg):
  """vcg (B, sy, sx) int32 -> the min-index image (B, sy*sx) int64:
  each pixel's component id is the least raster index in it."""
  B, sy, sx = vcg.shape
  dev = vcg.device
  left_ok = (vcg & 0b0010) > 0
  up_ok = (vcg & 0b1000) > 0
  left_ok[:, :, 0] = False
  up_ok[:, 0, :] = False
  no_x = torch.zeros((B, sy, 1), dtype=torch.bool, device=dev)
  no_y = torch.zeros((B, 1, sx), dtype=torch.bool, device=dev)
  blocked_x_f = ~left_ok
  blocked_x_b = ~torch.cat([left_ok[:, :, 1:], no_x], 2).flip(2)
  blocked_y_f = ~up_ok
  blocked_y_b = ~torch.cat([up_ok[:, 1:, :], no_y], 1).flip(1)

  def sweep(L):
    L = _seg_min(L, blocked_x_f, 2)
    L = _seg_min(L.flip(2), blocked_x_b, 2).flip(2)
    L = _seg_min(L, blocked_y_f, 1)
    return _seg_min(L.flip(1), blocked_y_b, 1).flip(1)

  n = sx * sy
  L = torch.arange(n, dtype=torch.int64, device=dev).reshape(1, sy, sx)
  L = L.expand(B, sy, sx)
  while True:
    L2 = sweep(L)
    if torch.equal(L2, L):
      break
    L = L2
  return L.reshape(B, n)


def _root_ranks(pf):
  """(is_root, first-visit rank of every root) of a min-index image."""
  n = pf.shape[1]
  is_root = pf == torch.arange(n, device=pf.device)[None, :]
  return is_root, torch.cumsum(is_root.to(torch.int64), 1) - 1


def ccl_plain(vcg):
  """vcg (B, sy, sx) int32 -> (cc (B, sy*sx) int32, N (B,) int32)."""
  pf = _min_image(vcg)
  _, rank = _root_ranks(pf)
  cc = torch.gather(rank, 1, pf)
  return cc.to(torch.int32), (rank[:, -1] + 1).to(torch.int32)


def paint_plain(cc, T):
  """painted[b, ch] = T[b, ch, cc] where cc < cap_n, else 0."""
  cap_n = T.shape[2]
  idx = torch.clamp(cc.to(torch.int64), 0, cap_n - 1)
  got = torch.gather(T, 2, idx[:, None, :].expand(-1, T.shape[1], -1))
  return torch.where((cc < cap_n)[:, None, :], got, 0)


def ccl_paint_plain(vcg, T=None):
  cc, N = ccl_plain(vcg)
  return cc, N, (paint_plain(cc, T) if T is not None else None)


def _check_vcg(name, vcg):
  if vcg.dtype != torch.int32 or vcg.dim() != 3 or not vcg.is_contiguous():
    raise ValueError(f"{name}: want a contiguous (B, sy, sx) int32 vcg, "
                     f"got {tuple(vcg.shape)} {vcg.dtype}")


def _tiles(name, vcg):
  """(tile, tiles per slice) of the CCL kernels for vcg."""
  if TILE_PIX < 32 or TILE_PIX > 8192 or TILE_PIX & (TILE_PIX - 1):
    raise ValueError(f"TILE_PIX must be a power of two in [32, 8192]: "
                     f"{TILE_PIX}")
  n = vcg.shape[1] * vcg.shape[2]
  if n >= 2 ** 31:
    raise ValueError(f"{name}: {n} pixels a slice, want fewer than 2^31")
  return TILE_PIX, -(-n // TILE_PIX)


def ccl_paint(vcg, T=None):
  """Kernel 4: vcg (B, sy, sx) int32 and an optional paint table T
  (B, K, cap_n) int32, K in {1, 2}, cap_n <= PAINT_CAP_N ->
  (cc (B, sy*sx) int32, N (B,) int32, painted (B, K, sy*sx) int32 or
  None when T is None)."""
  _check_vcg("ccl_paint", vcg)
  B, sy, sx = vcg.shape
  if T is not None:
    if (T.dtype != torch.int32 or T.dim() != 3 or T.shape[0] != B
        or T.shape[1] not in (1, 2) or not T.is_contiguous()
        or not 1 <= T.shape[2] <= PAINT_CAP_N):
      raise ValueError(f"ccl_paint: bad paint table {tuple(T.shape)} "
                       f"{T.dtype}")
    if T.device != vcg.device:
      raise ValueError("ccl_paint: vcg and T on different devices")
  if vcg.device.type != "cuda":
    return ccl_paint_plain(vcg, T)
  K = 0 if T is None else T.shape[1]
  cap_n = 1 if T is None else T.shape[2]
  n = sx * sy
  dev = vcg.device
  cc = torch.empty((B, n), dtype=torch.int32, device=dev)
  N = torch.empty((B,), dtype=torch.int32, device=dev)
  painted = (torch.empty((B, K, n), dtype=torch.int32, device=dev)
             if K else None)
  tile, tiles = _tiles("ccl_paint", vcg)
  if B and n:
    L = torch.empty((B, n), dtype=torch.int32, device=dev)
    counts = torch.empty((B, tiles), dtype=torch.int32, device=dev)
    lib = _build.library()
    err = lib.ccl_paint_launch(
      vcg.data_ptr(), T.data_ptr() if K else None, L.data_ptr(),
      counts.data_ptr(), cc.data_ptr(), N.data_ptr(),
      painted.data_ptr() if K else None, B, sx, sy, K, cap_n, tile,
      torch.cuda.current_stream(dev).cuda_stream)
    _build.check("ccl_paint", err)
    _build.LAUNCHES["ccl_paint"] += 1
  return cc, N, painted


def ccl_min_plain(vcg):
  B, sy, sx = vcg.shape
  pf = _min_image(vcg)
  is_root, rank = _root_ranks(pf)
  tgt = torch.where(is_root, rank, -1)
  return (pf.to(torch.int32).reshape(B, sy, sx),
          tgt.to(torch.int32).reshape(B, sy, sx))


def ccl_min(vcg):
  """Kernel 5: vcg (B, sy, sx) int32 -> (L, tgt), both (B, sy, sx)
  int32: L is each pixel's component id, the least raster index of its
  component; tgt is the first-visit rank at roots (L[p] == p) and -1
  elsewhere (ccl_pallas.ccl_min_traced)."""
  _check_vcg("ccl_min", vcg)
  if vcg.device.type != "cuda":
    return ccl_min_plain(vcg)
  B, sy, sx = vcg.shape
  tile, tiles = _tiles("ccl_min", vcg)
  L = torch.empty_like(vcg)
  tgt = torch.empty_like(vcg)
  if B and sx * sy:
    counts = torch.empty((B, tiles), dtype=torch.int32, device=vcg.device)
    err = _build.library().ccl_min_launch(
      vcg.data_ptr(), L.data_ptr(), counts.data_ptr(), tgt.data_ptr(), B,
      sx, sy, tile, torch.cuda.current_stream(vcg.device).cuda_stream)
    _build.check("ccl_min", err)
    _build.LAUNCHES["ccl_min"] += 1
  return L, tgt


def ccl_min_roots(vcg, cap_n: int):
  """Kernel 5 with the roots: vcg (B, sy, sx) int32 -> (L (B, sy, sx),
  roots (B, cap_n), N (B,)), all int32: ccl_min's L, and what
  roots_from_tgt(tgt, cap_n) makes of its tgt, written by the rank pass
  itself, which writes no tgt: each slice's component minima in
  first-visit order, padded with sy*sx, ranks at or past cap_n dropped,
  N the full root count."""
  _check_vcg("ccl_min_roots", vcg)
  if cap_n < 1:
    raise ValueError(f"ccl_min_roots: cap_n must be at least 1: {cap_n}")
  if vcg.device.type != "cuda":
    L, tgt = ccl_min_plain(vcg)
    return (L,) + roots_from_tgt(tgt, cap_n)
  B, sy, sx = vcg.shape
  dev = vcg.device
  tile, tiles = _tiles("ccl_min_roots", vcg)
  L = torch.empty_like(vcg)
  roots = torch.empty((B, cap_n), dtype=torch.int32, device=dev)
  N = torch.empty((B,), dtype=torch.int32, device=dev)
  if B and sx * sy:
    counts = torch.empty((B, tiles), dtype=torch.int32, device=dev)
    err = _build.library().ccl_min_roots_launch(
      vcg.data_ptr(), L.data_ptr(), counts.data_ptr(), roots.data_ptr(),
      N.data_ptr(), B, sx, sy, cap_n, tile,
      torch.cuda.current_stream(dev).cuda_stream)
    _build.check("ccl_min_roots", err)
    _build.LAUNCHES["ccl_min_roots"] += 1
  else:
    roots.fill_(sx * sy)
    N.zero_()
  return L, roots, N


def roots_from_tgt(tgt, cap_n: int):
  """Sorted component minima per slice (first-visit order), padded with
  n = sy*sx, from ccl_min's tgt: roots[b, tgt[b, p]] = p. Returns
  (roots (B, cap_n) int32, N (B,) int32). Ranks at or past cap_n are
  dropped, as the reference's one-hot scatter drops them."""
  B = tgt.shape[0]
  n = tgt[0].numel() if B else 0
  tf = tgt.reshape(B, n).to(torch.int64)
  N = (tf.max(1).values + 1).to(torch.int32) if n else \
    torch.zeros(B, dtype=torch.int32, device=tgt.device)
  roots = torch.full((B, cap_n + 1), n, dtype=torch.int32,
                     device=tgt.device)
  idx = torch.where((tf >= 0) & (tf < cap_n), tf, cap_n)
  src = torch.arange(n, dtype=torch.int32, device=tgt.device)
  roots.scatter_(1, idx, src.expand(B, n))
  return roots[:, :cap_n].contiguous(), N


def _pow2_cap(cap_n: int) -> int:
  return max(8, 1 << max(int(cap_n) - 1, 0).bit_length())


def plant_plain(L, roots, T):
  B = L.shape[0]
  n = L[0].numel() if B else 0
  cap_n = roots.shape[1]
  lf = L.reshape(B, n).contiguous()
  k = torch.searchsorted(roots.contiguous(), lf)
  kc = torch.clamp(k, max=cap_n - 1)
  hit = ((k < cap_n) & (torch.gather(roots, 1, kc) == lf)
         & (lf >= 0) & (lf < n))
  cc = torch.where(hit, k, 0).to(torch.int32)
  K = 0 if T is None else T.shape[1]
  if not K:
    return cc, torch.zeros((B, 0, n), dtype=torch.int32, device=L.device)
  got = torch.gather(T, 2, kc[:, None, :].expand(-1, K, -1))
  return cc, torch.where(hit[:, None, :], got, 0)


def plant_span(B: int, n: int, sms: int) -> int:
  """Pixels of a block of the plant kernel (a multiple of 4) on a card
  of `sms` SMs (PLANT_FILL, PLANT_MIN_SPAN)."""
  blocks = max(1, min(-(-n // PLANT_MIN_SPAN),
                      -(-PLANT_FILL * sms // max(B, 1))))
  return 4 * -(-n // (4 * blocks))


def plant(L, roots, T=None):
  """Kernel 6: the min-index image L (B, sy, sx) int32, sorted roots
  (B, cap_n) int32 padded with sy*sx, and value tables T (B, K, cap_n)
  int32 with K in {1, 2} (or None for K = 0) -> (cc (B, sy*sx) int32,
  painted (B, K, sy*sx) int32): where roots[k] == L[p], cc[p] = k and
  painted[:, p] = T[:, k]; elsewhere 0 (ccl_pallas.plant_traced). Any
  cap_n: the kernel stages no table in shared memory."""
  if L.dtype != torch.int32 or L.dim() != 3 or not L.is_contiguous():
    raise ValueError(f"plant: want a contiguous (B, sy, sx) int32 L, got "
                     f"{tuple(L.shape)} {L.dtype}")
  B, sy, sx = L.shape
  if (roots.dtype != torch.int32 or roots.dim() != 2
      or roots.shape[0] != B or not roots.is_contiguous()
      or roots.shape[1] < 1):
    raise ValueError(f"plant: bad roots {tuple(roots.shape)} {roots.dtype}")
  cap_n = roots.shape[1]
  if T is not None and (
      T.dtype != torch.int32 or T.dim() != 3 or T.shape[0] != B
      or T.shape[1] not in (1, 2) or T.shape[2] != cap_n
      or not T.is_contiguous()):
    raise ValueError(f"plant: bad value table {tuple(T.shape)} {T.dtype}")
  if roots.device != L.device or (T is not None and T.device != L.device):
    raise ValueError("plant: L, roots and T on different devices")
  if L.device.type != "cuda":
    return plant_plain(L, roots, T)
  K = 0 if T is None else T.shape[1]
  n = sx * sy
  dev = L.device
  cc = torch.empty((B, n), dtype=torch.int32, device=dev)
  painted = torch.empty((B, K, n), dtype=torch.int32, device=dev)
  if B and n:
    # root -> k, written at the roots only: the kernel checks each
    # entry it reads against the roots
    rmap = torch.empty((B, n), dtype=torch.int32, device=dev)
    span = plant_span(B, n, _build.sm_count(dev))
    vec = n % 4 == 0 and L.data_ptr() % 16 == 0
    err = _build.library().plant_launch(
      L.data_ptr(), roots.data_ptr(), T.data_ptr() if K else None,
      rmap.data_ptr(), cc.data_ptr(), painted.data_ptr() if K else None, B,
      n, K, cap_n, span, int(vec),
      torch.cuda.current_stream(dev).cuda_stream)
    _build.check("plant", err)
    _build.LAUNCHES["plant"] += 1
  return cc, painted


def ccl_paint_v2(vcg, T):
  """ccl_min_roots -> plant: the same (cc, N, painted) as ccl_paint(vcg,
  T) from one converge pass and a plant (ccl_pallas.ccl_paint_v2, whose
  first two steps are ccl_min_traced and roots_from_tgt)."""
  cap_n = T.shape[2]
  cap2 = _pow2_cap(cap_n)
  if cap2 != cap_n:
    T = torch.nn.functional.pad(T, (0, cap2 - cap_n))
  L, roots, N = ccl_min_roots(vcg, cap2)
  cc, painted = plant(L, roots, T)
  return cc, N, painted
