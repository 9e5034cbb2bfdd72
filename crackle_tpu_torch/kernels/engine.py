"""Host glue for the torch decode engine.

Counterpart of crackle_tpu/kernels/engine.py for flat and
condensed-pins streams: parses the container sections with the port's
host layer (its copy of the reference's), pads the per-slice crack
streams and pin tables into fixed-shape tensors, parks them on a torch
device as a DeviceStream, and decodes windows there with the kernels of
this package. Slices longer than MAX_DEVICE_CAP codepoints split at
chain boundaries into pieces (prepare_split_inputs); decode_window is
the whole-window entry point that codec.decompress reaches under
set_engine('torch').
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
from ..utils.profiling import annotate, count, span
from . import ccl as _ccl
from . import crc32c as _crc
from . import decode as _dec

logger = logging.getLogger("crackle_tpu_torch.engine")


def _fallback(fn: str, reason: str):
  """Every None return in this module routes through here so callers
  can tell 'unsupported stream' from 'broken code path'."""
  logger.warning("%s: declined, use the host codec: %s", fn, reason)
  return None


def _next_pow2(x: int) -> int:
  if x <= 1:
    return 1
  return 1 << (x - 1).bit_length()


# the reference's codepoint capacity for a device window (engine.py's
# MAX_DEVICE_CAP default); longer slices split into chain-aligned pieces
MAX_DEVICE_CAP = 1 << 17


def _device_cap_ok(inputs) -> bool:
  return inputs["packed"].shape[1] * 4 <= MAX_DEVICE_CAP


def _pack_diffs(cps: np.ndarray) -> bytes:
  """Codepoints -> packed 2-bit diff bytes, the first codepoint
  absolute. Zero-pad diffs in the last byte replicate the final
  codepoint, which never forms a branch/terminate pair, so the replay
  drops them like sub-byte padding."""
  cps = cps.astype(np.int64)
  diffs = cps.copy()
  diffs[1:] = (cps[1:] - cps[:-1]) & 3
  pad = (-len(diffs)) % 4
  if pad:
    diffs = np.concatenate([diffs, np.zeros(pad, np.int64)])
  q = diffs.reshape(-1, 4)
  by = (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4)
        | (q[:, 3] << 6)).astype(np.uint8)
  return by.tobytes()


def _prep_one(code: bytes, head, model):
  """One slice's crack code -> (packed move bytes, chain start nodes).
  Markov streams rank-decode on the host and re-pack as 2-bit diffs."""
  if len(code) == 0:
    return b'', np.zeros(0, np.int64)
  index_size = 4 + ctoi(code, 0, 4)
  nodes = _cc.read_boc_index(code, head.sx, head.sy)
  if model is None:
    return code[index_size:], nodes
  return _pack_diffs(_markov.decode_markov(
    code[index_size:], model, head.markov_model_order)), nodes


def _pad_rows(head, prepped):
  """[(packed bytes, nodes), ...] -> the padded numpy inputs dict."""
  B = len(prepped)
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


@annotate("engine.prep")
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
  return _pad_rows(head, prepped)


# pieces of a split slice hold at most this many codepoints (the
# reference's SPLIT_TARGET_CPS, engine.py:136)
SPLIT_TARGET_CPS = 1 << 16


def _split_slice_stream(code: bytes, nodes: np.ndarray, max_cps: int):
  """Split one slice's packed move stream (BOC stripped) at chain
  boundaries into pieces of at most max_cps codepoints
  (engine.py:139-180).

  Chains replay independently, each from its own start node with a
  scope of its own, and the codepoint at a chain start never is a
  pair-second (it follows one), so a piece whose first codepoint is
  re-based as absolute classifies exactly as it did in the stream.
  Returns [(packed bytes, nodes of the piece), ...], or None where one
  chain alone exceeds max_cps."""
  cps = _cc.unpack_codepoints(code, 0)
  s, kind = _cc.classify_codepoints(cps)
  ends, ok = _cc.segment_chains(kind, s, len(nodes))
  if not ok:
    return None
  starts = np.concatenate([[0], ends[:-1] + 2]).astype(np.int64)
  bounds = np.concatenate([starts, [ends[-1] + 2]]).astype(np.int64)
  n_chains = len(nodes)
  pieces = []
  i = 0
  while i < n_chains:
    # the largest j with bounds[j] - bounds[i] <= max_cps
    j = min(int(np.searchsorted(bounds, bounds[i] + max_cps,
                                side='right')) - 1, n_chains)
    if j <= i:
      return None
    pieces.append((_pack_diffs(cps[bounds[i]:bounds[j]]), nodes[i:j]))
    i = j
  return pieces


@annotate("engine.prep")
def prepare_split_inputs(binary: bytes, z_start: int, z_end: int,
                         max_cps: int = 0):
  """prepare_slice_inputs for windows whose slices exceed the device
  capacity (engine.py:183-238): each slice longer than max_cps
  codepoints (default min(SPLIT_TARGET_CPS, MAX_DEVICE_CAP)) becomes
  chain-aligned pieces, one row each. Returns (the inputs dict over the
  P pieces, piece_z (P,) int32 window-local slice of each piece, in
  order), or None for a markov stream or where one chain alone exceeds
  max_cps."""
  head = _codec.header(binary)
  if head.markov_model_order > 0:
    return None
  if not max_cps:
    max_cps = min(SPLIT_TARGET_CPS, MAX_DEVICE_CAP)
  prepped, piece_z = [], []
  for wz, code in enumerate(_codec.crack_codes(binary)[z_start:z_end]):
    body, nodes = _prep_one(code, head, None)
    if len(body) * 4 <= max_cps:
      pieces = [(body, nodes)]
    else:
      pieces = _split_slice_stream(body, nodes, max_cps)
      if pieces is None:
        return None
    prepped += pieces
    piece_z += [wz] * len(pieces)
  return _pad_rows(head, prepped), np.asarray(piece_z, np.int32)


@annotate("codec.parse")
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


@annotate("codec.parse")
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


def _upload(a, dev, dtype) -> torch.Tensor:
  """A host array as a tensor on dev: one copy from pageable memory,
  which on a card waits for it (a host sync)."""
  count("host_syncs")
  return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)


def _i32(a, dev):
  with span("engine.upload", dev):
    return _upload(a, dev, np.int32)


def params_from_jax(inputs, T=None, device="cpu", pins=None, piece_z=None):
  """Carry the reference's decode state across: the numpy arrays of
  crackle_tpu.kernels.engine.prepare_slice_inputs or
  prepare_split_inputs (or this module's), plus an optional plant table
  T, optional pins tables (the tuple of
  crackle_tpu.kernels.engine._pins_device_tables, or this module's),
  and the piece -> slice map of split inputs, as tensors on `device`.
  The pins come back as (pin_locs, pin_labs, single_ids, single_labs,
  bg32, cap_n) under "pins", the map as int32 under "piece_z"."""
  dev = torch.device(device)
  with span("engine.upload", dev):
    out = {
      "packed": _upload(inputs["packed"], dev, np.uint8),
      "nbytes": _i32(inputs["nbytes"], dev),
      "nodes": _i32(inputs["nodes"], dev),
      "n_chains": _i32(inputs["n_chains"], dev),
    }
    if T is not None:
      out["T"] = _i32(T, dev)
    if pins is not None:
      out["pins"] = tuple(_i32(a, dev) for a in pins[:4]) + (
        int(pins[4]), int(pins[5]))
    if piece_z is not None:
      out["piece_z"] = _i32(piece_z, dev)
  return out


def _check_window(head, z_start: int, z_end: int):
  if not 0 <= z_start < z_end <= head.sz:
    raise ValueError(f"window [{z_start}, {z_end}) outside [0, {head.sz}) "
                     f"or empty")


def _device(device) -> torch.device:
  dev = torch.device(device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(f"device {dev} requested but CUDA is not available")
  return dev


def _window_vcg(binary: bytes, inputs, z_start: int, z_end: int, dev,
                fn: str):
  """The per-slice VCG (B, sy, sx) int32 of the window whose
  prepare_slice_inputs are `inputs`, on `dev`: through the three replay
  kernels, or, where a slice passes MAX_DEVICE_CAP codepoints, through
  chain-aligned pieces (engine.py:256-274) replayed as rows of their own,
  each slice painted from the edge ids of all its pieces. Returns None,
  with the reason logged under fn, for a markov stream that would need
  the split and where one chain or piece passes the limits."""
  head = inputs["head"]
  permissible = head.crack_format == CrackFormat.PERMISSIBLE
  if _device_cap_ok(inputs):
    t = params_from_jax(inputs, device=dev)
    with span("decode.replay_ccl", dev):
      return _dec._vcg_for_ccl(t["packed"], t["nbytes"], t["nodes"],
                               t["n_chains"], head.sx, head.sy, permissible)
  res = prepare_split_inputs(binary, z_start, z_end)
  if res is None:
    return _fallback(fn, "a markov stream or a single chain exceeds the "
                         "piece limit")
  pieces, piece_z = res
  if not _device_cap_ok(pieces):
    return _fallback(fn, "a piece exceeds MAX_DEVICE_CAP")
  t = params_from_jax(pieces, device=dev, piece_z=piece_z)
  with span("decode.replay_ccl", dev):
    return _dec.decode_pieces_to_vcg(
      t["packed"], t["nbytes"], t["nodes"], t["n_chains"], t["piece_z"],
      z_end - z_start, sx=head.sx, sy=head.sy, permissible=permissible)


def decode_window_vcg_device(binary: bytes, z_start: int, z_end: int,
                             device="cuda"):
  """Decode a z window to its per-slice 4-bit VCG (B, sy, sx) int32 on
  `device`, the crack-format complement applied (bits -y +y -x +x, as
  codec.decode_slice_vcg gives them): the replay kernels only, with no
  CCL and no CRC gate. Slices longer than MAX_DEVICE_CAP codepoints
  split into chain-aligned pieces. Returns None (with the reason logged)
  where the split declines."""
  dev = _device(device)
  _check_window(_codec.header(binary), z_start, z_end)
  return _window_vcg(binary, prepare_slice_inputs(binary, z_start, z_end),
                     z_start, z_end, dev, "decode_window_vcg_device")


def decode_window_ccl_device(binary: bytes, z_start: int, z_end: int,
                             device="cuda"):
  """Decode a z window to per-slice first-visit CCL images that stay
  on `device`. Returns (cc (B, sy*sx) int32, N (B,) int32, head), or
  None (with the reason logged) where the host rules decline the
  stream. Slices longer than MAX_DEVICE_CAP codepoints split into
  chain-aligned pieces."""
  dev = _device(device)
  _check_window(_codec.header(binary), z_start, z_end)
  inputs = prepare_slice_inputs(binary, z_start, z_end)
  vcg = _window_vcg(binary, inputs, z_start, z_end, dev,
                    "decode_window_ccl_device")
  if vcg is None:
    return None
  with span("decode.replay_ccl", dev):
    cc, N, _ = _ccl.ccl_paint(vcg)
  return cc, N, inputs["head"]


def crc_gate(cc, stored, z_start: int):
  """Raise FormatError naming the first slice whose CRC32C of cc (B,
  sy*sx) int32, computed on cc's device, differs from its stored word
  (stored: (B,) int64 on the same device). The host waits once, for the
  first mismatching slice (kernel 11 finds it on the card), and twice
  more for the message of a mismatch."""
  with span("engine.crc_gate", cc.device):
    got, first = _crc.crc32c_first_mismatch(cc, stored)
    count("host_syncs")
    i = int(first)
    if i < cc.shape[0]:
      count("host_syncs", 2)
      raise FormatError(
        f"crackle: crack code crc mismatch on z={z_start + i} "
        f"computed: {int(got[i])} stored: {int(stored[i])}")


def _check_window_crcs(binary, head, cc, z_start: int):
  """The CRC gate of a decoded window against the stream's stored
  words, where the format version carries them."""
  stored = _stored_crcs(head, binary, cc.device)
  if stored is not None:
    crc_gate(cc, stored[z_start:z_start + cc.shape[0]], z_start)


def decode_window_ccl(binary: bytes, z_start: int, z_end: int,
                      check_crcs: bool = True, device="cuda"):
  """Decode a z window to per-slice first-visit CCL images
  (engine.py:302-325). Returns (cc (B, sy*sx) int32, N (B,) int32) as
  host numpy arrays, or None where decode_window_ccl_device declines.
  check_crcs=True checks each slice's CRC32C on the device first."""
  res = decode_window_ccl_device(binary, z_start, z_end, device)
  if res is None:
    return None
  cc, N, head = res
  if check_crcs:
    _check_window_crcs(binary, head, cc, z_start)
  with span("engine.copy_back", cc.device):
    count("d2h_bytes", 4 * (cc.numel() + N.numel()))
    count("host_syncs", 2)
    return cc.cpu().numpy(), N.cpu().numpy()


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

    with span("DeviceStream.decode_window", self.device):
      with span("decode.replay_ccl", self.device):
        if self.pins is not None:
          pl_, pb_, si_, sl_, bg32, cap_n = self.pins
          labels, cc, N = _dec.decode_slices_full_pins(
            win(self.packed), win(self.nbytes), win(self.nodes),
            win(self.n_chains), win(pl_), win(pb_), win(si_), win(sl_),
            bg32, sx=self.head.sx, sy=self.head.sy,
            permissible=self.permissible, cap_n=cap_n)
        else:
          labels, cc, N = _dec.decode_slices_full_plant(
            win(self.packed), win(self.nbytes), win(self.nodes),
            win(self.n_chains), win(self.T), sx=self.head.sx,
            sy=self.head.sy, permissible=self.permissible)
      if check_crcs and self.crcs is not None:
        crc_gate(cc, self.crcs[z_start:z_end], z_start)
    return labels, cc, N


def _stored_crcs(head, binary, dev):
  if head.format_version > 0:
    stored = _codec.crack_crcs(binary)
    if stored is not None:
      with span("engine.upload", dev):
        return _upload(np.asarray(stored, dtype='<u4'), dev, np.int64)
  return None


def upload_stream(binary: bytes, device="cuda") -> Optional[DeviceStream]:
  """Parse a crackle stream and park it on `device` as a DeviceStream.
  Returns None (with a logged reason) for a label format other than
  flat or condensed pins, a slice longer than MAX_DEVICE_CAP codepoints
  or more than PAINT_CAP_N components in a slice of a flat stream (as
  the reference does; decode_window takes both), or pins labels stored
  wider than 32 bits.
  Every slice size is taken otherwise: the paint runs in bands of
  pixels, none past one block's shared memory (replay.paint_grid),
  where the reference's flat upload declines 1024^2 slices for a TPU
  VMEM limit."""
  dev = _device(device)
  with span("engine.upload_stream", dev):
    return _upload_stream(binary, dev)


def _upload_stream(binary: bytes, dev) -> Optional[DeviceStream]:
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
  with span("engine.prep"):
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


def _window_labels(binary: bytes, z_start: int, z_end: int, dev, fn: str,
                   split_ok: bool):
  """Decode a z window to labels on `dev`: (labels (B, sy*sx) uint32 or
  uint64, cc (B, sy*sx) int32, N (B,) int32, vcg (B, sy, sx) int32, head),
  or None with the reason logged under fn.

  Pins windows take pins_labels_from_vcg; flat windows the in-kernel
  paint (labels_from_vcg, K = 1 or 2) up to PAINT_CAP_N components a
  slice and the gather paint (ccl_paint, paint_labels_u32) past it or
  where the slices split into pieces (split_ok). Declined: pins labels
  stored wider than 32 bits, pins or (without split_ok) flat slices past
  MAX_DEVICE_CAP, u64 labels past PAINT_CAP_N or split, a label format
  other than flat or pins, and what _window_vcg declines."""
  head = _codec.header(binary)
  pins = head.label_format == LabelFormat.PINS_VARIABLE_WIDTH
  if not pins and head.label_format != LabelFormat.FLAT:
    return _fallback(fn, f"unsupported label format {head.label_format}")
  inputs = prepare_slice_inputs(binary, z_start, z_end)
  split = not _device_cap_ok(inputs)
  if split and (pins or not split_ok):
    return _fallback(fn, "stream exceeds MAX_DEVICE_CAP")
  if pins:
    tables = _pins_device_tables(head, binary, z_start, z_end)
    if tables is None:
      return _fallback(fn, "pins tables unavailable (stored width > 4)")
  else:
    uniq, cum, keys = _flat_label_tables(head, binary)
    n_per_slice = cum[z_start + 1:z_end + 1] - cum[z_start:z_end]
    max_n = int(n_per_slice.max()) if len(n_per_slice) else 1
    cap_n = _next_pow2(max(max_n, 8))
    plant = not split and cap_n <= _ccl.PAINT_CAP_N
    if not plant and uniq.dtype.itemsize > 4:
      return _fallback(fn, "u64 labels without the plant kernel")
  vcg = _window_vcg(binary, inputs, z_start, z_end, dev, fn)
  if vcg is None:
    return None
  if pins:
    pt = [_i32(a, dev) for a in tables[:4]]
    with span("decode.replay_ccl", dev):
      labels, cc, N = _dec.pins_labels_from_vcg(
        vcg, *pt, int(tables[4]), int(tables[5]))
  elif plant:
    with span("engine.prep"):
      T = plant_table(uniq, cum, keys, z_start, z_end, cap_n)
    T = _i32(T, dev)
    with span("decode.replay_ccl", dev):
      labels, cc, N = _dec.labels_from_vcg(vcg, T)
  else:
    tabs = _gather_tables(uniq, cum, keys, z_start, z_end, dev)
    with span("decode.replay_ccl", dev):
      cc, N, _ = _ccl.ccl_paint(vcg)
      labels = _dec.paint_labels_u32(cc, *tabs)
  return labels, cc, N, vcg, head


def decode_window_device(binary: bytes, z_start: int, z_end: int,
                         device="cuda"):
  """Decode a z window on `device` (engine.py:421-497). Returns (labels
  (B, sy*sx) uint32 or uint64, cc (B, sy*sx) int32, N (B,) int32, head),
  all on the device, or None (with the reason logged) for a slice longer
  than MAX_DEVICE_CAP codepoints, pins labels stored wider than 32 bits,
  a label format other than flat or pins, and u64 labels with more than
  PAINT_CAP_N components in a slice.

  Pins windows take decode_slices_full_pins' route; flat windows the
  in-kernel paint (decode_slices_full_plant's, K = 1 or 2) up to
  PAINT_CAP_N components a slice and the gather paint (decode_slices_full's)
  past it."""
  dev = _device(device)
  _check_window(_codec.header(binary), z_start, z_end)
  res = _window_labels(binary, z_start, z_end, dev, "decode_window_device",
                       split_ok=False)
  if res is None:
    return None
  labels, cc, N, _vcg, head = res
  return labels, cc, N, head


def decode_window_labels_device(binary: bytes, z_start: int, z_end: int,
                                device="cuda"):
  """Decode a z window to labels that stay on `device`: what
  decode_window decodes before its CRC gate and its copy to host memory.
  Returns (labels (B, sy*sx) uint32 or uint64, cc (B, sy*sx) int32, vcg
  (B, sy, sx) int32), the VCG the labels were decoded from, or None (with
  the reason logged) where decode_window declines with label=None: pins
  or markov slices past MAX_DEVICE_CAP, u64 labels past PAINT_CAP_N or
  split, a single chain past the piece limit, pins labels stored wider
  than 32 bits. Long flat slices split into pieces and take the gather
  paint."""
  dev = _device(device)
  _check_window(_codec.header(binary), z_start, z_end)
  res = _window_labels(binary, z_start, z_end, dev,
                       "decode_window_labels_device", split_ok=True)
  if res is None:
    return None
  labels, cc, _N, vcg, _head = res
  return labels, cc, vcg


def _gather_tables(uniq, cum, keys, z_start: int, z_end: int, dev):
  """The gather paint's tables on `dev`: each slice's first component
  (int64), the component -> uniq-index keys (int64) and uniq as int32
  bits (labels of at most 32 bits)."""
  with span("engine.upload", dev):
    return (_upload(cum[z_start:z_end], dev, np.int64),
            _upload(keys, dev, np.int64),
            _upload(uniq.astype(np.uint32).view(np.int32), dev, np.int32))


def _host_volume(labels, head, B: int) -> np.ndarray:
  """(B, sy*sx) labels on a device -> the host (sx, sy, B) volume in the
  header's memory order; a C-order volume is transposed on the device
  before the copy (through its signed view: torch's unsigned types
  have few kernels)."""
  signed = {torch.uint32: torch.int32, torch.uint64: torch.int64}
  unsigned = {torch.uint32: np.uint32, torch.uint64: np.uint64}
  with span("engine.copy_back", labels.device):
    vol = labels.view(signed.get(labels.dtype, labels.dtype))
    vol = vol.reshape(B, head.sy, head.sx).permute(2, 1, 0)
    if not head.fortran_order:
      vol = vol.contiguous()  # else (B, sy, sx) rows are already F order
    count("d2h_bytes", vol.numel() * vol.element_size())
    count("host_syncs")
    vol = vol.cpu().numpy()
  return vol.view(unsigned[labels.dtype]) if labels.dtype in unsigned \
    else vol


def decode_window(binary: bytes, z_start: int, z_end: int,
                  label: Optional[int] = None, check_crcs: bool = True,
                  device="cuda") -> Optional[np.ndarray]:
  """Decode a z window on `device` (engine.py:664-739). Returns the host
  numpy (sx, sy, z_end - z_start) volume in the header's memory order
  and dtype, or with label= the boolean mask of that label, or None
  (with the reason logged) where the stream needs the host decoder:
  a label= query of a pins stream, and the windows that
  decode_window_labels_device declines.

  label=None takes decode_window_labels_device; a label= query of a flat
  stream the CCL images of decode_window_ccl_device and paint_keys.
  check_crcs=True checks each slice's CRC32C on the device."""
  dev = _device(device)
  head = _codec.header(binary)
  _check_window(head, z_start, z_end)
  B = z_end - z_start
  if label is None:
    res = decode_window_labels_device(binary, z_start, z_end, dev)
    if res is None:
      return _fallback("decode_window",
                       "decode_window_labels_device declined")
    labels, cc, _ = res
  elif head.label_format == LabelFormat.PINS_VARIABLE_WIDTH:
    return _fallback("decode_window",
                     "a label= query of a pins stream stays on the host")
  elif head.label_format != LabelFormat.FLAT:
    return _fallback("decode_window",
                     f"unsupported label format {head.label_format}")
  else:
    res = decode_window_ccl_device(binary, z_start, z_end, dev)
    if res is None:
      return _fallback("decode_window", "decode_window_ccl_device declined")
    cc, _, _ = res
    uniq, cum, keys = _flat_label_tables(head, binary)
    pos = int(np.searchsorted(uniq, label))
    if pos < len(uniq) and uniq[pos] == label:
      offsets, keys_t, _ = _gather_tables(uniq, cum, keys, z_start, z_end,
                                          dev)
      labels = _dec.paint_keys(cc, offsets, keys_t) == pos
    else:
      labels = torch.zeros_like(cc, dtype=torch.bool)
  if check_crcs:
    _check_window_crcs(binary, head, cc, z_start)
  out = _host_volume(labels, head, B)
  return out if label is not None else out.astype(head.dtype, copy=False)
