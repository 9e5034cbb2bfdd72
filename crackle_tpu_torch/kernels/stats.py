"""Per-component slice statistics of first-visit CCL images.

Counterpart of crackle_tpu/kernels/stats_pallas.py: count, x/y sums and
x/y extents of every component of every slice in one pass over the CCL
image, for voxel_counts, centroids and bounding_boxes. The kernel is
csrc/stats.cu; the plain version below scatters into tensors.

Unlike the reference's f32 block, the statistics are int64: the TPU's
f32 sums stop being exact past 2^24 (the x-sum of a component covering
a 512^2 slice is about 6.7e7), the port's are exact.
"""
import torch

from . import _build

# output channel layout (stats_pallas.py:41-43)
CH_COUNT, CH_XSUM, CH_YSUM, CH_XMIN, CH_XMAX, CH_YMIN, CH_YMAX = range(7)
N_CH = 8  # padded

# x-min and y-min of an empty component (the reference's is 3e38)
EMPTY_MIN = 2 ** 31 - 1

# largest cap_n the kernel's shared-memory accumulators take
MAX_CAP_N = 4096

# pixels of a band, the rows one block of the kernel takes (whole rows,
# at least one and at most 32); tests shrink it to cross band seams
BAND_PX = 16384

_KW = 128     # the reference's one-hot window height
_STRIPE = 8   # the reference's rows per window-bound probe


def eligible(sx: int, sy: int, cap_n: int) -> bool:
  """The shapes the reference's stats kernel takes (stats_pallas.py:
  130-138); analytics declines the others as the reference does."""
  if sy % _STRIPE != 0:
    return False
  if cap_n > MAX_CAP_N or sx > 1024 or sx < 8:
    return False
  vmem = ((cap_n + _KW) * sx * 4 + (cap_n + _KW) * 128 * 4
          + 4 * cap_n * sx * 4)
  return vmem <= 12 * 1024 * 1024


def slice_stats_plain(cc, sx: int, sy: int, cap_n: int):
  B = cc.shape[0]
  dev = cc.device
  ids = cc.to(torch.int64)
  keep = (ids >= 0) & (ids < cap_n)
  ids = torch.where(keep, ids, cap_n)  # column cap_n is dropped
  p = torch.arange(sx * sy, device=dev)
  xs = (p % sx).expand(B, -1)
  ys = (p // sx).expand(B, -1)

  def acc(fill, src, reduce):
    out = torch.full((B, cap_n + 1), fill, dtype=torch.int64, device=dev)
    if reduce == "sum":
      out.scatter_add_(1, ids, src)
    else:
      out.scatter_reduce_(1, ids, src, reduce, include_self=True)
    return out[:, :cap_n]

  chans = [acc(0, torch.ones_like(xs), "sum"), acc(0, xs, "sum"),
           acc(0, ys, "sum"), acc(EMPTY_MIN, xs, "amin"),
           acc(-1, xs, "amax"), acc(EMPTY_MIN, ys, "amin"),
           acc(-1, ys, "amax"),
           torch.zeros((B, cap_n), dtype=torch.int64, device=dev)]
  return torch.stack(chans, 2)


def slice_stats(cc, sx: int, sy: int, cap_n: int):
  """Kernel 7: cc (B, sy*sx) int32 first-visit ids -> (B, cap_n, 8)
  int64 per-component count, x-sum, y-sum, x-min, x-max, y-min, y-max
  and a zero pad (stats_pallas.slice_stats). Empty components read
  count 0, mins EMPTY_MIN and maxes -1; ids outside [0, cap_n) are not
  counted."""
  if (cc.dtype != torch.int32 or cc.dim() != 2
      or cc.shape[1] != sx * sy or not cc.is_contiguous()):
    raise ValueError(f"slice_stats: want a contiguous (B, {sy}*{sx}) int32 "
                     f"cc, got {tuple(cc.shape)} {cc.dtype}")
  if not 1 <= cap_n <= MAX_CAP_N:
    raise ValueError(f"slice_stats: cap_n {cap_n} outside [1, {MAX_CAP_N}]")
  if cc.device.type != "cuda":
    return slice_stats_plain(cc, sx, sy, cap_n)
  band_rows = min(32, max(1, BAND_PX // sx))
  # the kernel keeps a band's sums in 32 bits and a run's x-extent in 16
  if (not 4 <= sx < 2 ** 16
      or band_rows * sx * max(sx, band_rows) >= 2 ** 31):
    raise ValueError(f"slice_stats: the kernel takes rows of 4 to "
                     f"{2 ** 16 - 1} pixels whose bands' sums fit 32 bits, "
                     f"got {sx}")
  B = cc.shape[0]
  out = torch.empty((B, cap_n, N_CH), dtype=torch.int64, device=cc.device)
  if B:
    if cc.data_ptr() % 16:  # the kernel reads ids in 16-byte loads
      cc = cc.clone()
    err = _build.library().slice_stats_launch(
      cc.data_ptr(), out.data_ptr(), B, sx, sy, cap_n, band_rows,
      torch.cuda.current_stream(cc.device).cuda_stream)
    _build.check("slice_stats", err)
    _build.LAUNCHES["slice_stats"] += 1
  return out
