"""Per-slice 4-connected CCL with first-visit numbering and label paint.

Counterpart of crackle_tpu/kernels/ccl_pallas.py (ccl_batch_traced and
ccl_paint_traced). The kernel (csrc/ccl.cu) is a union-find with union
by min; its plain version below follows decode._ccl_batch: alternating
row/column segmented-min sweeps to a fixed point, then the first-visit
renumber, plus the table paint.
"""
import torch

from . import _build

# largest per-slice paint table (ccl_pallas.PAINT_CAP_N)
PAINT_CAP_N = 2048


def _seg_min(L, blocked, dim):
  """Segmented inclusive min scan along dim; a segment starts where
  `blocked` is set. Segment ids grow along the scan, so one cummax of
  seg * BIG - L is the running minimum within each segment."""
  big = L.shape[1] * L.shape[2] + 1
  seg = torch.cumsum(blocked.to(torch.int64), dim)
  return seg * big - torch.cummax(seg * big - L, dim).values


def ccl_plain(vcg):
  """vcg (B, sy, sx) int32 -> (cc (B, sy*sx) int32, N (B,) int32)."""
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
  pf = L.reshape(B, n)
  is_root = pf == torch.arange(n, device=dev)[None, :]
  rank = torch.cumsum(is_root.to(torch.int64), 1) - 1
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


def ccl_paint(vcg, T=None):
  """Kernel 4: vcg (B, sy, sx) int32 and an optional paint table T
  (B, K, cap_n) int32, K in {1, 2}, cap_n <= PAINT_CAP_N ->
  (cc (B, sy*sx) int32, N (B,) int32, painted (B, K, sy*sx) int32 or
  None when T is None)."""
  if vcg.dtype != torch.int32 or vcg.dim() != 3 or not vcg.is_contiguous():
    raise ValueError(f"ccl_paint: want a contiguous (B, sy, sx) int32 "
                     f"vcg, got {tuple(vcg.shape)} {vcg.dtype}")
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
  if B and n:
    L = torch.empty((B, n), dtype=torch.int32, device=dev)
    lib = _build.library()
    err = lib.ccl_paint_launch(
      vcg.data_ptr(), T.data_ptr() if K else None, L.data_ptr(),
      cc.data_ptr(), N.data_ptr(), painted.data_ptr() if K else None,
      B, sx, sy, K, cap_n, torch.cuda.current_stream(dev).cuda_stream)
    _build.check("ccl_paint", err)
    _build.LAUNCHES["ccl_paint"] += 1
  return cc, N, painted
