"""Flat-label encode with the per-voxel stages on a torch device.

Counterpart of crackle_tpu/kernels/encode.py. On the labels' device,
in batches of whole slices: the 4-bit VCG from label equality, the
first-visit CCL (``ccl.ccl_paint`` with no table, the CUDA kernel on a
card), each component's source label, each slice's CRC32C of cc and the
flat pixel pairs that pick the crack format. The crack-code trace is
serial per slice and stays on the host (the native library, on a
thread pool); the VCG reaches it nibble-packed, copied in chunks on a
side stream while earlier chunks are traced.

Labels are compared through the signed view of their width (uint32 as
int32, uint64 as int64): torch's unsigned types have few CUDA kernels.

The condensed-pins encode (allow_pins=1) keeps each slice's first-visit
ids from the same stage 1 in place of the label tables and finds the
pins on the device too (ops/pins.py solve).

  data = encode_flat_device(labels)   # (sx, sy, sz) uint8..uint64
  data = encode_pins_device(labels)   # the same with allow_pins=1
  data = codec.compress(labels)       # the same for a torch tensor
"""
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import codec as _codec
from .. import native
from ..headers import CrackFormat, LabelFormat
from ..lib import width2dtype
from ..ops import labels as _labels
from ..ops import pins as _pins
from ..utils.profiling import annotate, count, span
from . import ccl as _ccl
from . import crc32c as _crc
from .engine import _fallback

# pixels of a stage-1 batch (whole slices, at least one): bounds the
# device memory of the batch's VCG, cc, the CCL's scratch and the CRC's
# int64 bit planes, about 40 bytes a pixel
STAGE1_PIX = 1 << 25

# the most slices a CCL launch takes (its grid's y extent)
_MAX_GRID_Y = 65535

# bytes of VCG nibbles copied to the host a chunk
FETCH_CHUNK_BYTES = 4 << 20

_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}
_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)
_NP_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
              np.dtype(np.uint64): np.int64}
_NP_UNSIGNED = {torch.uint16: np.uint16, torch.uint32: np.uint32,
                torch.uint64: np.uint64}


def _signed(labels):
  return labels.view(_SIGNED.get(labels.dtype, labels.dtype))


def _bits(x):
  """Labels in a signed view -> their unsigned values as int64 bits."""
  if x.element_size() == 8:
    return x.to(torch.int64)
  return x.to(torch.int64) & ((1 << (8 * x.element_size())) - 1)


def host_labels(labels) -> np.ndarray:
  """A label tensor -> a host numpy array of the same shape and unsigned
  dtype, through its signed view."""
  if labels.dtype in _NP_UNSIGNED:
    return _signed(labels).cpu().numpy().view(_NP_UNSIGNED[labels.dtype])
  return labels.cpu().numpy()


def labels_to_vcg(labels_zyx):
  """(B, sy, sx) labels -> (B, sy, sx) int32 4-bit VCGs, the layout
  ccl_paint reads: bits +x, -x, +y, -y set where that neighbour holds
  the same label, the decoder's convention (encode.py labels_to_vcg)."""
  a = _signed(labels_zyx)
  vcg = torch.zeros(a.shape, dtype=torch.int32, device=a.device)
  same_x = (a[:, :, :-1] == a[:, :, 1:]).to(torch.int32)
  vcg[:, :, :-1] |= same_x
  vcg[:, :, 1:] |= same_x << 1
  del same_x
  same_y = (a[:, :-1] == a[:, 1:]).to(torch.int32)
  vcg[:, :-1] |= same_y << 2
  vcg[:, 1:] |= same_y << 3
  return vcg


def _ccl_of(vcg):
  B, sy, sx = vcg.shape
  if not vcg.numel():
    return (torch.zeros((B, sx * sy), dtype=torch.int32, device=vcg.device),
            torch.zeros((B,), dtype=torch.int32, device=vcg.device))
  cc, N, _ = _ccl.ccl_paint(vcg)
  return cc, N


def ccl_from_labels(labels_zyx):
  """(B, sy, sx) labels -> (cc (B, sy*sx) int32, N (B,) int32): the
  first-visit CCL of each slice, the host CCL's numbering, with N =
  max(cc) + 1 (0 for a slice of no pixels)."""
  return _ccl_of(labels_to_vcg(labels_zyx))


def _pixel_pairs(flat):
  """Neighbouring equal labels of a 1-D label run, an int64 tensor."""
  a = _signed(flat)
  return (a[1:] == a[:-1]).sum()


def format_stats(labels_flat):
  """(pixel pairs, max label) of a flat label run as int64 tensors, the
  max as the label's unsigned bits (0 when empty), for the encoder's
  format choice (crackle.hpp:48-55). The reference's API, held against
  it in the tests; the encode itself counts pairs in _encode_stage1 and
  takes the max label from the label tables."""
  a = _signed(labels_flat)
  pairs = _pixel_pairs(a)
  if not a.numel():
    return pairs, torch.zeros((), dtype=torch.int64, device=a.device)
  if a.element_size() == 8:
    # flipping the sign bit maps unsigned order onto signed order
    top = torch.iinfo(torch.int64).min
    return pairs, (a ^ top).max() ^ top
  return pairs, _bits(a).max()


def component_labels(labels_zyx, cc, N):
  """Each component's source label, the flat encode's per-slice
  mapping: (B, cap_n) int64 label bits whose row b holds at k < N[b]
  the label at component k's first-visit pixel. cap_n is the power of
  two at or above max(N) (at least 1), as in the reference, whose pad
  (k >= N[b]) repeats the slice's last label; so does this one. N: (B,)
  on any device."""
  B = labels_zyx.shape[0]
  n = cc.shape[1]
  count("host_syncs", bool(B))
  top = int(N.max()) if B else 0
  cap_n = max(1, 1 << max(top - 1, 0).bit_length())
  out = torch.zeros((B, cap_n), dtype=torch.int64, device=cc.device)
  if not B or not n:
    return out
  flat = _signed(labels_zyx).reshape(B, n)
  out[:] = _bits(flat[:, n - 1:])
  # first-visit numbering: component k first appears where cc passes the
  # running max of the pixels before it
  first = torch.ones(cc.shape, dtype=torch.bool, device=cc.device)
  first[:, 1:] = cc[:, 1:] > torch.cummax(cc, 1).values[:, :-1]
  count("host_syncs")  # nonzero's size
  b, p = torch.nonzero(first, as_tuple=True)
  out[b, cc[b, p].to(torch.int64)] = _bits(flat[b, p])
  return out


def _encode_stage1(planes):
  """The per-voxel encode stages of a (B, sy, sx) label batch in one call
  (encode.py _encode_stage1): (vcg (B, sy, sx) int32, cc (B, sy*sx)
  int32, N (B,) int32, crcs (B,) int64, pairs), pairs being the flat (z,
  y, x) pixel pairs of the batch, row and slice wraps included, as an
  int64 tensor."""
  vcg = labels_to_vcg(planes)
  cc, N = _ccl_of(vcg)
  crcs = _crc.crc32c_rows(cc)
  return vcg, cc, N, crcs, _pixel_pairs(planes.reshape(-1))


def _pack_vcg_nibbles(vcg):
  """(B, ...) 4-bit VCGs of n pixels a slice -> (B, ceil(n/2)) uint8,
  two pixels a byte, the even pixel in the low nibble: the trace's
  device -> host fetch at half the bytes."""
  B = vcg.shape[0]
  n = math.prod(vcg.shape[1:])
  v = vcg.reshape(B, n)
  if n % 2:
    v = torch.nn.functional.pad(v, (0, 1))
  v = v.reshape(B, (n + 1) // 2, 2)
  return (v[:, :, 0] | (v[:, :, 1] << 4)).to(torch.uint8)


def _unpack(row: np.ndarray, sxy: int) -> np.ndarray:
  out = np.empty(2 * row.shape[0], np.uint8)
  out[0::2] = row & 0x0F
  out[1::2] = row >> 4
  return out[:sxy]


def _fetch(packed):
  """Start the copy of nibble-packed VCG rows (sz, nb) to the host.
  Returns (the host rows as numpy, [(z0, z1, event or None)]): from a
  CUDA device the rows go into pinned memory in chunks of about
  FETCH_CHUNK_BYTES on a side stream, an event after each chunk; numpy
  or CPU rows are there already."""
  if isinstance(packed, np.ndarray):
    return packed, [(0, packed.shape[0], None)]
  sz, nb = packed.shape
  if packed.device.type != "cuda":
    return packed.numpy(), [(0, sz, None)]
  host = torch.empty((sz, nb), dtype=torch.uint8, pin_memory=True)
  side = torch.cuda.Stream(packed.device)
  side.wait_stream(torch.cuda.current_stream(packed.device))
  packed.record_stream(side)
  rows = max(1, FETCH_CHUNK_BYTES // max(nb, 1))
  chunks = []
  # the span's events on the side stream time the copies
  with torch.cuda.stream(side), span("encode.fetch", packed.device):
    count("d2h_bytes", sz * nb)
    for z0 in range(0, sz, rows):
      z1 = min(z0 + rows, sz)
      host[z0:z1].copy_(packed[z0:z1], non_blocking=True)
      ev = torch.cuda.Event()
      ev.record(side)
      chunks.append((z0, z1, ev))
  return host.numpy(), chunks


def _trace(packed, sx: int, sy: int, permissible: bool, parallel: int = 0):
  """Each slice's crack code from its nibble-packed VCG row (packed:
  (sz, ceil(sx*sy/2)) uint8, numpy or a tensor on any device), or None
  where the native trace overflows. A pool of codec._pool_size threads
  traces a chunk's slices once its copy's event has passed, while later
  chunks are still in flight."""
  sz = packed.shape[0]
  sxy = sx * sy
  rows, chunks = _fetch(packed)
  codes = [None] * sz

  def one(z):
    codes[z] = native.encode_slice_vcg(_unpack(rows[z], sxy), sx, sy,
                                       permissible)

  with span("encode.trace"), \
       ThreadPoolExecutor(_codec._pool_size(parallel, sz)) as pool:
    futs = []
    for z0, z1, ev in chunks:
      if ev is not None:
        count("host_syncs")
        ev.synchronize()
      futs += [pool.submit(one, z) for z in range(z0, z1)]
    for f in futs:
      f.result()
  return None if any(c is None for c in codes) else codes


@annotate("encode.assemble")
def assemble_flat_stream(packed, tables, N, crcs, num_pairs: int,
                         sx: int, sy: int, sz: int, *, data_width: int,
                         fortran_order: bool, parallel: int = 0):
  """The host tail of the device encode (encode.py assemble_flat_stream):
  the per-slice trace and the flat-label and container assembly, bytes
  equal to codec.compress. Returns the .ckl bytes, or None where the
  native trace overflows.

  packed: the nibble-packed VCGs (sz, ceil(sx*sy/2)) uint8 (numpy, or a
  tensor on any device; the reference takes them unpacked and packs
  them itself); tables (sz, cap) uint64, N (sz,), crcs (sz,) u32;
  num_pairs: the flat F-order pixel pairs of the whole volume."""
  mapping = np.concatenate([tables[z, :N[z]] for z in range(sz)]) \
    if sz else np.zeros(0, np.uint64)
  head = _codec.stream_header(
    (sx, sy, sz), data_width, int(mapping.max()) if len(mapping) else 0,
    num_pairs, fortran_order)
  codes = _trace(packed, sx, sy,
                 head.crack_format == CrackFormat.PERMISSIBLE, parallel)
  if codes is None:
    return None
  labels_binary = _codec.flat_labels_section(
    mapping, N, sx * sy, width2dtype[head.stored_data_width])
  return _codec.container(head, codes, labels_binary, crcs)


def _batch_slices(sz: int, n: int) -> int:
  """Slices of a stage-1 batch of a volume of sz slices of n pixels:
  STAGE1_PIX pixels (at least one slice), at most a CCL launch's grid."""
  return max(1, min(sz, STAGE1_PIX // n, _MAX_GRID_Y))


def _stage1_volume(zyx, keep_cc: bool = False):
  """Stage 1 of a contiguous (sz, sy, sx) label volume in batches of
  whole slices (STAGE1_PIX pixels): the nibble-packed VCGs (sz,
  ceil(sy*sx/2)) uint8 on zyx's device, and on the host the label
  tables (sz, cap) uint64, N (sz,) int32, the CRCs (sz,) uint32 and the
  volume's flat pixel pairs. keep_cc (the pins encode) keeps each
  slice's first-visit ids, (sz, sy*sx) int32 on zyx's device, in place
  of the label tables."""
  with span("encode.stage1", zyx.device):
    sz, sy, sx = zyx.shape
    n = sx * sy
    dev = zyx.device
    step = _batch_slices(sz, n)
    flat = _signed(zyx).reshape(sz, n)
    packed = torch.empty((sz, (n + 1) // 2), dtype=torch.uint8, device=dev)
    ccs = torch.empty((sz, n), dtype=torch.int32, device=dev) \
      if keep_cc else None
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    tabs, Ns, crcs = [], [], []
    for z0 in range(0, sz, step):
      planes = zyx[z0:z0 + step]
      vcg, cc, N, crc, p = _encode_stage1(planes)
      packed[z0:z0 + step] = _pack_vcg_nibbles(vcg)
      del vcg
      pairs += p
      if z0:  # the pair across the seam with the batch before
        pairs += flat[z0 - 1, -1] == flat[z0, 0]
      if keep_cc:
        ccs[z0:z0 + step] = cc
      else:
        count("host_syncs")
        tabs.append(component_labels(planes, cc, N).cpu().numpy())
      Ns.append(N)
      crcs.append(crc)
    tables = None
    if not keep_cc:
      tables = np.zeros((sz, max(t.shape[1] for t in tabs)), np.uint64)
      for z0, t in zip(range(0, sz, step), tabs):
        tables[z0:z0 + len(t), :t.shape[1]] = t.view(np.uint64)
    count("host_syncs", 3)  # N, the CRCs and the pairs to the host
    return (packed, tables if ccs is None else ccs,
            torch.cat(Ns).cpu().numpy(),
            torch.cat(crcs).cpu().numpy().astype(np.uint32), int(pairs))


def _device_labels(labels, device):
  """Unsigned labels as a tensor in their signed view (uint32 as int32,
  uint64 as int64): a tensor where it lies, a numpy array moved to
  `device`."""
  if isinstance(labels, torch.Tensor):
    return _signed(labels)
  arr = np.asarray(labels)
  return torch.from_numpy(arr.view(_NP_SIGNED.get(arr.dtype, arr.dtype))
                          ).to(device)


def decline_reason(labels):
  """Why encode_flat_device declines `labels` (a tensor, or what numpy
  takes), or None where it takes them: the native library is missing,
  the labels are not unsigned or not 3-d, the volume is empty (the
  reference's reasons), or a slice has 2^31 pixels or more (the port's
  CCL kernels index a slice with int32)."""
  if not native.available():
    return "the native trace library is missing"
  if isinstance(labels, torch.Tensor):
    unsigned = labels.dtype in _UNSIGNED
  else:
    labels = np.asarray(labels)
    unsigned = labels.dtype.kind == "u" and labels.dtype.isnative
  if not unsigned:
    return f"labels of dtype {labels.dtype}, not unsigned"
  if labels.ndim != 3:
    return f"{labels.ndim}-d labels"
  sx, sy, sz = labels.shape
  if sx * sy * sz == 0:
    return "an empty volume"
  if sx * sy >= 2 ** 31:
    return (f"{sx * sy} pixels a slice: the CCL kernels take fewer than "
            f"2^31")
  return None


def _zyx(labels, device):
  """(labels as a tensor in their signed view, their contiguous (sz, sy,
  sx) view): an F-order volume, or (B, sy*sx) rows reshaped and
  permuted, is that view without a copy."""
  t = _device_labels(labels, device)
  zyx = t.permute(2, 1, 0)
  if not zyx.is_contiguous():
    zyx = zyx.contiguous()
  return t, zyx


def _flat_stream(t, zyx, parallel: int, fortran_order: bool):
  sx, sy, sz = t.shape
  packed, tables, N, crcs, pairs = _stage1_volume(zyx)
  return assemble_flat_stream(
    packed, tables, N, crcs, pairs, sx, sy, sz,
    data_width=t.element_size(), fortran_order=fortran_order,
    parallel=parallel)


def encode_flat_device(labels, parallel: int = 0, fortran_order: bool = True,
                       device="cuda"):
  """compress for flat labels at markov order 0 with the per-voxel stages
  on a torch device (encode.py encode_flat_device). labels: (sx, sy,
  sz) uint8/16/32/64, a tensor on any device, or a numpy array that
  moves to `device`. Returns the .ckl bytes, equal to codec.compress of
  the same labels, or None: with decline_reason logged before any
  launch, or where the native trace overflows."""
  reason = decline_reason(labels)
  if reason is not None:
    return _fallback("encode_flat_device", reason)
  t, zyx = _zyx(labels, device)
  return _flat_stream(t, zyx, parallel, fortran_order)


def encode_pins_device(labels, parallel: int = 0, fortran_order: bool = True,
                       device="cuda", bgcolor=None):
  """compress(labels, allow_pins=1) at markov order 0 with the per-voxel
  stages and the pins' column scan and cover index (ops/pins.py solve)
  on a torch device; the fast solver's pick order, the trace and the
  assembly on the host. labels as for encode_flat_device; bgcolor as
  for compress. Returns the .ckl bytes, equal to codec.compress(labels,
  allow_pins=1): a flat stream where the labels' pixel pairs pick the
  flat format or there is one slice. None as for encode_flat_device."""
  reason = decline_reason(labels)
  if reason is not None:
    return _fallback("encode_pins_device", reason)
  t, zyx = _zyx(labels, device)
  sx, sy, sz = t.shape
  pairs, top = format_stats(zyx.reshape(-1))
  count("host_syncs", 2)
  head = _codec.stream_header((sx, sy, sz), t.element_size(), int(top),
                              int(pairs), fortran_order, allow_pins=1)
  if head.label_format == LabelFormat.FLAT:
    return _flat_stream(t, zyx, parallel, fortran_order)
  packed, cc, N, crcs, _ = _stage1_volume(zyx, keep_cc=True)
  n_total = int(N.sum())
  # global ids: each slice's ids after the components of the slices
  # before it
  wide = torch.int32 if n_total < 2 ** 31 else torch.int64
  base = torch.from_numpy(np.cumsum(N, dtype=np.int64) - N).to(cc.device)
  cc = cc.to(wide)
  cc += base[:, None].to(wide)
  all_pins = _pins.solve(zyx.reshape(sz, sx * sy), cc, sx, sy, sz, n_total)
  del cc
  codes = _trace(packed, sx, sy, False, parallel)
  if codes is None:
    return None
  with span("encode.assemble"):
    labels_binary = _labels.encode_condensed_pins(
      all_pins, sx, sy, sz, head.pin_index_width(), N, n_total,
      width2dtype[head.stored_data_width], bgcolor is None,
      0 if bgcolor is None else int(bgcolor))
    return _codec.container(head, codes, labels_binary, crcs)
