"""Host glue for the torch decode engine.

Counterpart of crackle_tpu/kernels/engine.py for flat and
condensed-pins streams: parses the container sections with the port's
host layer (its copy of the reference's), pads the per-slice crack
streams and pin tables into fixed-shape tensors, parks them on a torch
device as a DeviceStream, and decodes windows there with the kernels of
this package.
"""
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from .. import codec as _codec
from ..headers import CrackFormat, FormatError, LabelFormat
from ..lib import compute_dtype, ctoi
from ..models import markov as _markov
from ..ops import crackcode as _cc
from ..ops import labels as _labels_ops
from . import ccl as _ccl
from . import crc32c as _crc
from . import decode as _dec

logger = logging.getLogger("crackle_tpu_torch.engine")


def _fallback(fn: str, reason: str):
  """Every None return in this module routes through here so callers
  can tell 'unsupported stream' from 'broken code path'."""
  logger.warning("%s: declined, use the host decoder: %s", fn, reason)
  return None


def _next_pow2(x: int) -> int:
  if x <= 1:
    return 1
  return 1 << (x - 1).bit_length()


# the reference's codepoint capacity for a device window (engine.py's
# MAX_DEVICE_CAP default); longer slices are declined
MAX_DEVICE_CAP = 1 << 17


def _device_cap_ok(inputs) -> bool:
  return inputs["packed"].shape[1] * 4 <= MAX_DEVICE_CAP


def _prep_one(code: bytes, head, model):
  """One slice's crack code -> (packed move bytes, chain start nodes).
  Markov streams rank-decode on the host and re-pack as 2-bit diffs;
  zero-pad diffs in the last byte replicate the final codepoint, which
  never forms a branch/terminate pair, so the replay drops them like
  sub-byte padding."""
  if len(code) == 0:
    return b'', np.zeros(0, np.int64)
  index_size = 4 + ctoi(code, 0, 4)
  nodes = _cc.read_boc_index(code, head.sx, head.sy)
  if model is None:
    return code[index_size:], nodes
  cps = _markov.decode_markov(
    code[index_size:], model, head.markov_model_order).astype(np.int64)
  diffs = cps.copy()
  diffs[1:] = (cps[1:] - cps[:-1]) & 3
  pad = (-len(diffs)) % 4
  if pad:
    diffs = np.concatenate([diffs, np.zeros(pad, np.int64)])
  q = diffs.reshape(-1, 4)
  by = (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4)
        | (q[:, 3] << 6)).astype(np.uint8)
  return by.tobytes(), nodes


def prepare_slice_inputs(binary: bytes, z_start: int, z_end: int):
  """Parse and pad the crack streams of a z window: numpy arrays
  packed (B, CAP_B) uint8, nbytes (B,) int32, nodes (B, CAP_CH) int32,
  n_chains (B,) int32, and the header."""
  head = _codec.header(binary)
  markov = head.markov_model_order > 0
  model = _codec.decode_markov_model(head, binary) if markov else None
  codes = _codec.crack_codes(binary)[z_start:z_end]
  B = len(codes)
  if markov and B > 8:
    # the rank decode is serial per slice; the native bitstream decoder
    # releases the GIL, so threads overlap slices
    with ThreadPoolExecutor(min(os.cpu_count() or 1, B)) as pool:
      prepped = list(pool.map(lambda c: _prep_one(c, head, model), codes))
  else:
    prepped = [_prep_one(c, head, model) for c in codes]

  max_bytes = max((len(p) for p, _ in prepped), default=0)
  max_chains = max((len(n) for _, n in prepped), default=0)
  CAP_B = _next_pow2(max(max_bytes, 4))
  CAP_CH = _next_pow2(max(max_chains, 2))
  packed = np.zeros((B, CAP_B), np.uint8)
  nbytes = np.zeros(B, np.int32)
  nodes = np.zeros((B, CAP_CH), np.int32)
  n_chains = np.zeros(B, np.int32)
  for i, (p, nd) in enumerate(prepped):
    packed[i, :len(p)] = np.frombuffer(p, np.uint8)
    nbytes[i] = len(p)
    nodes[i, :len(nd)] = nd
    n_chains[i] = len(nd)
  return {"head": head, "packed": packed, "nbytes": nbytes,
          "nodes": nodes, "n_chains": n_chains}


def _flat_label_tables(head, binary):
  lb = bytes(_codec.raw_labels(binary))
  n_labels = _labels_ops.decode_num_labels(head, lb)
  uniq = _labels_ops.decode_uniq(head, lb)
  cpg = _labels_ops.components_per_grid(head, lb).astype(np.int64)
  cum = np.concatenate([[0], np.cumsum(cpg)])
  offset = (8 + n_labels * head.stored_data_width
            + head.component_width() * head.num_grids())
  keys = np.frombuffer(lb, offset=offset, dtype=compute_dtype(n_labels))
  return uniq, cum, keys


def plant_table(uniq, cum, keys, z_start: int, z_end: int, cap_n: int):
  """(B, K, cap_n) int32 per-slice painted-value tables: entry k of
  slice z is the label of component cum[z] + k, K = 2 (lo, hi planes)
  for labels wider than 32 bits; entries past the stream's last
  component are 0."""
  t64 = uniq.astype(np.uint64)[keys.astype(np.int64)]
  idx = (cum[z_start:z_end, None]
         + np.arange(cap_n)[None, :]).astype(np.int64)
  planes = [(t64 & 0xffffffff).astype(np.uint32).view(np.int32)]
  if uniq.dtype.itemsize > 4:
    planes.append((t64 >> 32).astype(np.uint32).view(np.int32))
  return np.stack([
    np.concatenate([p, np.zeros(cap_n, np.int32)])[idx] for p in planes
  ], axis=1)


def _pack_by_slice(B: int, zi: np.ndarray, cols: list, fills: list):
  """Group (zi, col...) tuples into per-slice padded (B, CAP) arrays."""
  order = np.argsort(zi, kind='stable')
  zi = zi[order]
  counts = np.bincount(zi, minlength=B)
  CAP = _next_pow2(max(int(counts.max()) if B else 0, 1))
  outs = []
  starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
  within = np.arange(len(zi)) - np.repeat(starts, counts)
  for col, fill in zip(cols, fills):
    out = np.full((B, CAP), fill, np.int32)
    out[zi, within] = col[order]
    outs.append(out)
  return outs


def _pins_device_tables(head, binary: bytes, z_start: int, z_end: int):
  """Host parse of a condensed-pins section into per-slice device
  scatter inputs (labels.hpp:508-617 is the serial equivalent).

  Returns (pin_locs, pin_labs, single_ids, single_labs, bg32, cap_n)
  or None when stored labels exceed 32 bits."""
  if head.stored_data_width > 4:
    return None
  lb = bytes(_codec.raw_labels(binary))
  layout = _labels_ops.decode_condensed_pins_layout(head, lb)
  pins, singles = _labels_ops.decode_condensed_pins(head, lb)
  cpg = layout["components_per_grid"].astype(np.int64)
  cum = np.concatenate([[0], np.cumsum(cpg)])
  B = z_end - z_start
  sxy = head.sx * head.sy

  # cc singles: global component ids -> (slice, window-local id)
  ids, labs = [], []
  for label, ccs in singles.items():
    if len(ccs):
      ids.append(np.asarray(ccs, np.int64))
      labs.append(np.full(len(ccs), np.uint32(label).view(np.int32)))
  if ids:
    ids = np.concatenate(ids)
    labs = np.concatenate(labs)
    zs = np.searchsorted(cum, ids, side='right') - 1
    keep = (zs >= z_start) & (zs < z_end)
    ids, labs, zs = ids[keep], labs[keep], zs[keep]
    local = (ids - cum[zs]).astype(np.int32)
    single_ids, single_labs = _pack_by_slice(
      B, (zs - z_start).astype(np.int64), [local, labs], [-1, 0])
  else:
    single_ids = np.full((B, 1), -1, np.int32)
    single_labs = np.zeros((B, 1), np.int32)

  # pins: (index, depth) -> one (slice, in-slice position) per voxel
  locs, labs2, zz = [], [], []
  for label, plist in pins.items():
    for index, depth in plist:
      z0 = index // sxy
      loc = index - z0 * sxy
      zlo = max(z0, z_start)
      zhi = min(z0 + depth, z_end - 1)
      if zhi < zlo:
        continue
      n = zhi - zlo + 1
      zz.append(np.arange(zlo - z_start, zhi - z_start + 1))
      locs.append(np.full(n, loc, np.int64))
      labs2.append(np.full(n, np.uint32(label).view(np.int32)))
  if zz:
    zz = np.concatenate(zz)
    locs = np.concatenate(locs).astype(np.int32)
    labs2 = np.concatenate(labs2)
    pin_locs, pin_labs = _pack_by_slice(
      B, zz, [locs, labs2], [-1, 0])
  else:
    pin_locs = np.full((B, 1), -1, np.int32)
    pin_labs = np.zeros((B, 1), np.int32)

  n_per = cpg[z_start:z_end]
  cap_n = _next_pow2(max(int(n_per.max()) if len(n_per) else 1, 8))
  bg32 = int(np.uint32(layout["bgcolor"]).view(np.int32))
  return pin_locs, pin_labs, single_ids, single_labs, bg32, cap_n


def _i32(a, dev):
  return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)


def params_from_jax(inputs, T=None, device="cpu", pins=None):
  """Carry the reference's decode state across: the numpy arrays of
  crackle_tpu.kernels.engine.prepare_slice_inputs (or this module's),
  plus an optional plant table T, and optional pins tables (the tuple
  of crackle_tpu.kernels.engine._pins_device_tables, or this module's),
  as tensors on `device`. The pins come back as (pin_locs, pin_labs,
  single_ids, single_labs, bg32, cap_n) under "pins"."""
  dev = torch.device(device)
  out = {
    "packed": torch.from_numpy(np.ascontiguousarray(
      inputs["packed"], np.uint8)).to(dev),
    "nbytes": _i32(inputs["nbytes"], dev),
    "nodes": _i32(inputs["nodes"], dev),
    "n_chains": _i32(inputs["n_chains"], dev),
  }
  if T is not None:
    out["T"] = _i32(T, dev)
  if pins is not None:
    out["pins"] = tuple(_i32(a, dev) for a in pins[:4]) + (
      int(pins[4]), int(pins[5]))
  return out


def _device(device) -> torch.device:
  dev = torch.device(device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(f"device {dev} requested but CUDA is not available")
  return dev


def decode_window_ccl_device(binary: bytes, z_start: int, z_end: int,
                             device="cuda"):
  """Decode a z window to per-slice first-visit CCL images that stay
  on `device`. Returns (cc (B, sy*sx) int32, N (B,) int32, head), or
  None where the host rules decline the stream."""
  dev = _device(device)
  inputs = prepare_slice_inputs(binary, z_start, z_end)
  if not _device_cap_ok(inputs):
    return _fallback("decode_window_ccl_device",
                     "stream exceeds MAX_DEVICE_CAP")
  head = inputs["head"]
  t = params_from_jax(inputs, device=dev)
  cc, N = _dec.decode_slices_to_ccl(
    t["packed"], t["nbytes"], t["nodes"], t["n_chains"], sx=head.sx,
    sy=head.sy, permissible=head.crack_format == CrackFormat.PERMISSIBLE)
  return cc, N, head


class DeviceStream:
  """A compressed flat-label or condensed-pins crackle stream resident
  on a torch device.

  The parsed sections are uploaded once (about the compressed size);
  every window decode after that runs from device memory with no host
  transfer, and check_crcs=True verifies the per-slice crack CRC32Cs
  on the device as well. A flat stream carries its plant table T, a
  pins stream its pin and single tables (pins) instead."""

  def __init__(self, head, packed, nbytes, nodes, n_chains, T,
               permissible: bool, crcs=None, pins=None):
    self.head = head
    self.packed = packed
    self.nbytes = nbytes
    self.nodes = nodes
    self.n_chains = n_chains
    self.T = T
    self.permissible = permissible
    self.crcs = crcs  # (sz,) int64 stored per-slice crack crc32cs
    # pins streams: (pin_locs, pin_labs, single_ids, single_labs, bg32,
    # cap_n), the four per-slice tables on the device
    self.pins = pins

  @property
  def device(self) -> torch.device:
    return self.packed.device

  @property
  def nbytes_device(self) -> int:
    arrs = [self.packed, self.nbytes, self.nodes, self.n_chains]
    if self.T is not None:
      arrs.append(self.T)
    if self.pins is not None:
      arrs.extend(self.pins[:4])
    if self.crcs is not None:
      arrs.append(self.crcs)
    return sum(a.numel() * a.element_size() for a in arrs)

  def decode_window(self, z_start: int, z_end: int,
                    check_crcs: bool = False):
    """Decode [z_start, z_end) on the device. Returns (labels (B,
    sy*sx) uint32 or uint64, cc (B, sy*sx) int32, N (B,) int32).

    check_crcs=True computes each slice's CRC32C of cc on the device
    and raises FormatError naming the first slice that disagrees with
    its stored word."""
    if not 0 <= z_start <= z_end <= self.head.sz:
      raise ValueError(f"window [{z_start}, {z_end}) outside "
                       f"[0, {self.head.sz})")

    def win(a):
      return a[z_start:z_end]

    if self.pins is not None:
      pl_, pb_, si_, sl_, bg32, cap_n = self.pins
      labels, cc, N = _dec.decode_slices_full_pins(
        win(self.packed), win(self.nbytes), win(self.nodes),
        win(self.n_chains), win(pl_), win(pb_), win(si_), win(sl_), bg32,
        sx=self.head.sx, sy=self.head.sy, permissible=self.permissible,
        cap_n=cap_n)
    else:
      labels, cc, N = _dec.decode_slices_full_plant(
        win(self.packed), win(self.nbytes), win(self.nodes),
        win(self.n_chains), win(self.T), sx=self.head.sx,
        sy=self.head.sy, permissible=self.permissible)
    if check_crcs and self.crcs is not None:
      bad = _crc.crc32c_rows(cc) != self.crcs[z_start:z_end]
      if bool(bad.any()):
        z = z_start + int(torch.nonzero(bad)[0, 0])
        raise FormatError(f"crackle: crack code crc mismatch on z={z}")
    return labels, cc, N


def _stored_crcs(head, binary, dev):
  if head.format_version > 0:
    stored = _codec.crack_crcs(binary)
    if stored is not None:
      return torch.from_numpy(
        np.asarray(stored, dtype='<u4').astype(np.int64)).to(dev)
  return None


def upload_stream(binary: bytes, device="cuda") -> Optional[DeviceStream]:
  """Parse a crackle stream and park it on `device` as a DeviceStream.
  Returns None (with a logged reason) for a label format other than
  flat or condensed pins, a slice longer than MAX_DEVICE_CAP codepoints
  (the split decode is not ported), more than PAINT_CAP_N components in
  a slice of a flat stream, or pins labels stored wider than 32 bits.
  Every slice size is taken otherwise: the paint goes to bands of pixels
  past one block's shared memory (replay.paint_band_px), where the
  reference's flat upload declines 1024^2 slices for a TPU VMEM
  limit."""
  dev = _device(device)
  head = _codec.header(binary)
  if head.label_format == LabelFormat.PINS_VARIABLE_WIDTH:
    return _upload_pins_stream(head, binary, dev)
  if head.label_format != LabelFormat.FLAT:
    return _fallback("upload_stream",
                     f"label format {head.label_format} != FLAT")
  inputs = prepare_slice_inputs(binary, 0, head.sz)
  if not _device_cap_ok(inputs):
    return _fallback("upload_stream", "stream exceeds MAX_DEVICE_CAP")
  uniq, cum, keys = _flat_label_tables(head, binary)
  n_per_slice = cum[1:head.sz + 1] - cum[0:head.sz]
  max_n = int(n_per_slice.max()) if len(n_per_slice) else 1
  cap_n = _next_pow2(max(max_n, 8))
  if cap_n > _ccl.PAINT_CAP_N:
    return _fallback("upload_stream",
                     f"cap_n={cap_n} > PAINT_CAP_N={_ccl.PAINT_CAP_N}")
  T = plant_table(uniq, cum, keys, 0, head.sz, cap_n)
  t = params_from_jax(inputs, T, device=dev)
  return DeviceStream(
    head, t["packed"], t["nbytes"], t["nodes"], t["n_chains"], t["T"],
    permissible=head.crack_format == CrackFormat.PERMISSIBLE,
    crcs=_stored_crcs(head, binary, dev))


def _upload_pins_stream(head, binary: bytes, dev):
  """Park a condensed-pins stream on `dev`: packed crack sections plus
  the per-slice pin and single tables, so window decodes need no
  further host parsing or copies (engine.py:633-661)."""
  inputs = prepare_slice_inputs(binary, 0, head.sz)
  if not _device_cap_ok(inputs):
    return _fallback("upload_stream", "stream exceeds MAX_DEVICE_CAP")
  tables = _pins_device_tables(head, binary, 0, head.sz)
  if tables is None:
    return _fallback("upload_stream",
                     "pins tables unavailable (stored width > 4)")
  t = params_from_jax(inputs, device=dev, pins=tables)
  return DeviceStream(
    head, t["packed"], t["nbytes"], t["nodes"], t["n_chains"], None,
    permissible=head.crack_format == CrackFormat.PERMISSIBLE,
    crcs=_stored_crcs(head, binary, dev), pins=t["pins"])
