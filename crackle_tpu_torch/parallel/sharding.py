"""Runs of the codec over several devices and processes, sharded on z.

Counterpart of crackle_tpu/parallel/sharding.py, with torch devices and
torch.distributed in place of jax.sharding. The codec's parallel axis is
z: slices are independent streams, so a window's rows split into
contiguous blocks in z order, one per shard of a 1-D mesh, and each
block is decoded (or encoded) on its shard's device with no
communication. What crosses shards is small: a label histogram, the
slices' byte lengths (the z index) and the encode's byte assembly.

The reference's shard_map steps map onto torch as follows:
  * a step runs once per shard, on the shard's device. Every shard's
    kernels are enqueued before any result is fetched, so shards on
    different cards overlap (the encode's stage 1 reads its tables back
    after each batch, so its shards run in turn);
  * psum is a sum over the mesh's shards, then dist.all_reduce over the
    mesh's process group where it has one (of any size, one rank too);
  * the tiled all_gather is a z-order cat over the shards, then
    dist.all_gather_into_tensor over the group.
A collective's tensors go to the device its backend takes
(collective_device): the rank's CUDA device under nccl, the CPU under
gloo, whose CUDA path has all_reduce and broadcast but no all_gather.
"""
import contextlib
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import codec as _codec
from ..headers import CrackFormat, LabelFormat
from ..kernels import decode as _dec
from ..kernels import encode as _enc
from ..kernels import engine as _engine
from ..kernels.engine import _fallback


@dataclasses.dataclass(frozen=True)
class Mesh:
  """A 1-D mesh over z: one torch.device per shard, in z order (a
  device may repeat, and then runs several shards), and the process
  group of a mesh that spans processes (None within one process). Across
  a group each rank holds its own mesh and its own rows, which continue
  in rank order; only sharded_roundtrip_step's reductions cross ranks."""
  devices: Tuple[torch.device, ...]
  axis_name: str = "z"
  group: Optional["dist.ProcessGroup"] = None


def make_mesh(devices=None, axis_name: str = "z", group=None) -> Mesh:
  """1-D mesh over the z (slice) axis: `devices` (anything torch.device
  takes), by default every visible CUDA device. Raises where CUDA is
  missing and a CUDA device is named or none is named."""
  if devices is None:
    if not torch.cuda.is_available():
      raise RuntimeError("make_mesh: CUDA is not available; name the "
                         "devices, e.g. make_mesh(['cpu'] * 8)")
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
  devs = []
  for d in devices:
    dev = _engine._device(d)
    if dev.type == "cuda" and dev.index is None:
      dev = torch.device("cuda", torch.cuda.current_device())
    devs.append(dev)
  if not devs:
    raise ValueError("make_mesh: no devices")
  return Mesh(tuple(devs), axis_name, group)


def collective_device(group) -> torch.device:
  """The device of a collective's tensors over `group`: the rank's CUDA
  device under nccl, else (gloo) the CPU."""
  if dist.get_backend(group) == "nccl":
    return torch.device("cuda", torch.cuda.current_device())
  return torch.device("cpu")


def _on(dev: torch.device):
  """The current-device context of dev (the kernels launch on the
  current stream of their tensors' device, which must be current)."""
  return torch.cuda.device(dev) if dev.type == "cuda" \
    else contextlib.nullcontext()


def _shards(mesh: Mesh, B: int):
  """[(device, z0, z1)] of each shard that holds rows: contiguous blocks
  of ceil(B / shards) rows in z order, the last one shorter, and none
  for a shard past the rows (the reference pads the batch instead; the
  outputs are the same)."""
  block = -(-B // len(mesh.devices))
  return [(d, i * block, min((i + 1) * block, B))
          for i, d in enumerate(mesh.devices) if i * block < B]


def _cat(parts, dev: torch.device):
  """The shards' tensors concatenated in z order on dev (unsigned ones
  through their signed view)."""
  dtype = parts[0].dtype
  out = torch.cat([_enc._signed(p).to(dev) for p in parts])
  return out.view(dtype)


def _tensor(x):
  """x (numpy or a tensor on any device) as a tensor."""
  return x if isinstance(x, torch.Tensor) else torch.from_numpy(
    np.ascontiguousarray(x))


def _replicas(a, devices):
  """device -> a copy of a (numpy or a tensor) on it, one per distinct
  device."""
  t = _tensor(a)
  return {d: t.to(d) for d in dict.fromkeys(devices)}


# the dtypes the kernels take of the rows they read
_ROW_DTYPES = {"packed": torch.uint8, "nbytes": torch.int32,
               "nodes": torch.int32, "n_chains": torch.int32,
               "offs": torch.int64}


def _rows(x, z0: int, z1: int, dev, dtype=None):
  """Rows [z0, z1) of x (numpy or a tensor on any device) on dev, as
  dtype where one is given."""
  return _tensor(x)[z0:z1].to(device=dev, dtype=dtype)


def _upload(arrays: dict, mesh: Mesh):
  """[(device, z0, z1, tensors)] of each shard: its rows of each named
  array (numpy or a tensor on any device; one row a slice) on its
  device, in the kernels' dtypes (_ROW_DTYPES). The host prep runs once
  for the window, so every shard has the window's CAP."""
  return [(d, z0, z1, {k: _rows(a, z0, z1, d, _ROW_DTYPES.get(k))
                       for k, a in arrays.items()})
          for d, z0, z1 in _shards(mesh, len(arrays["nbytes"]))]


def _crack_rows(inputs):
  """The per-slice crack arrays of prepare_slice_inputs' dict."""
  return {k: inputs[k] for k in ("packed", "nbytes", "nodes", "n_chains")}


def _decode_ccl(shards, sx: int, sy: int, permissible: bool):
  """decode_slices_to_ccl of each shard, all enqueued: [(cc, N)]."""
  out = []
  for d, _, _, t in shards:
    with _on(d):
      out.append(_dec.decode_slices_to_ccl(
        t["packed"], t["nbytes"], t["nodes"], t["n_chains"], sx=sx, sy=sy,
        permissible=permissible))
  return out


def decode_window_ccl_sharded(binary: bytes, z_start: int, z_end: int,
                              mesh: Optional[Mesh] = None):
  """Sharded decode of a z window to per-slice CCL images: each shard
  decodes a contiguous block of slices (pure data parallelism). Returns
  (cc (B, sy*sx) int32, N (B,) int32) as host numpy arrays, and the
  header."""
  if mesh is None:
    mesh = make_mesh()
  head = _codec.header(binary)
  _engine._check_window(head, z_start, z_end)
  inputs = _engine.prepare_slice_inputs(binary, z_start, z_end)
  res = _decode_ccl(_upload(_crack_rows(inputs), mesh), head.sx, head.sy,
                    head.crack_format == CrackFormat.PERMISSIBLE)
  first = mesh.devices[0]
  cc = _cat([c for c, _ in res], first)
  N = _cat([n for _, n in res], first)
  return cc.cpu().numpy(), N.cpu().numpy(), head


def sharded_decode_labels(binary: bytes, z_start: int, z_end: int,
                          mesh: Optional[Mesh] = None):
  """Full decode of a z window on the mesh: crack replay, CCL and label
  paint on each shard's device, the label tables replicated on each.
  Returns (labels (B, sy*sx) uint32, or uint64 for labels wider than 32
  bits, on the mesh's first device, head), or None with the reason
  logged.

  Flat streams take the gather paint (keys[cc + offset] into the
  dictionary), as the reference's shard_map step does; condensed-pins
  streams decode_slices_full_pins on each shard's rows."""
  if mesh is None:
    mesh = make_mesh()
  head = _codec.header(binary)
  _engine._check_window(head, z_start, z_end)
  inputs = _engine.prepare_slice_inputs(binary, z_start, z_end)
  perm = head.crack_format == CrackFormat.PERMISSIBLE

  if head.label_format == LabelFormat.FLAT:
    uniq, cum, keys = _engine._flat_label_tables(head, binary)
    shards = _upload(dict(_crack_rows(inputs), offs=cum[z_start:z_end]),
                     mesh)
    keys_on = _replicas(keys.astype(np.int64), mesh.devices)
    wide = uniq.dtype.itemsize > 4
    table = uniq.astype(np.uint64).view(np.int64) if wide else \
      uniq.astype(np.uint32).view(np.int32)
    uniq_on = _replicas(table, mesh.devices)
    labels = []
    for (d, _, _, t), (cc, _N) in zip(shards, _decode_ccl(
        shards, head.sx, head.sy, perm)):
      with _on(d):
        ki = _dec.paint_keys(cc, t["offs"], keys_on[d])
        labels.append(uniq_on[d][ki].view(
          torch.uint64 if wide else torch.uint32))
    return _cat(labels, mesh.devices[0]), head

  if head.label_format != LabelFormat.PINS_VARIABLE_WIDTH:
    return _fallback("sharded_decode_labels",
                     f"unsupported label format {head.label_format}")
  tables = _engine._pins_device_tables(head, binary, z_start, z_end)
  if tables is None:
    return _fallback("sharded_decode_labels",
                     "pins table extraction declined the stream")
  pin_locs, pin_labs, single_ids, single_labs, bg32, cap_n = tables
  shards = _upload(dict(_crack_rows(inputs), pin_locs=pin_locs,
                        pin_labs=pin_labs, single_ids=single_ids,
                        single_labs=single_labs), mesh)
  labels = []
  for d, _, _, t in shards:
    with _on(d):
      lab, _cc, _N = _dec.decode_slices_full_pins(
        t["packed"], t["nbytes"], t["nodes"], t["n_chains"], t["pin_locs"],
        t["pin_labs"], t["single_ids"], t["single_labs"], bg32, sx=head.sx,
        sy=head.sy, permissible=perm, cap_n=cap_n)
      labels.append(lab)
  return _cat(labels, mesh.devices[0]), head


def decompress_sharded(binary: bytes, mesh: Optional[Mesh] = None
                       ) -> Optional[np.ndarray]:
  """Decode the full volume with z-slices sharded across the mesh, the
  label paint on the devices. Returns the host volume in the header's
  memory order and dtype, or None with the reason logged."""
  head = _codec.header(binary)
  res = sharded_decode_labels(binary, 0, head.sz, mesh)
  if res is None:
    return None  # reason already logged by sharded_decode_labels
  labels, head = res
  return _engine._host_volume(labels, head, head.sz).astype(head.dtype,
                                                           copy=False)


# ---------------------------------------------------------------------------
# Sharded reductions: the collective patterns of the codec
# ---------------------------------------------------------------------------

def _key_counts(cc, offs, keys, n: int):
  """(n,) int64 histogram of keys[cc + offs] on cc's device; keys past n
  are dropped, as the reference's scatter-add drops them."""
  ki = _dec.paint_keys(cc, offs, keys).reshape(-1)
  return torch.bincount(ki, minlength=n)[:n]


def _sum(parts, dev: torch.device):
  """The shards' tensors summed on dev."""
  total = parts[0].to(dev)
  for p in parts[1:]:
    total = total + p.to(dev)
  return total


def _all_reduce(t, mesh: Mesh):
  """t summed over the ranks of the mesh's group, on t's device."""
  group = mesh.group
  if group is None:
    return t
  buf = t.to(collective_device(group))
  dist.all_reduce(buf, group=group)
  return buf.to(t.device)


def _all_gather(local, mesh: Mesh):
  """local (this rank's rows in z order) gathered from every rank of the
  group in rank order, on local's device; ranks may hold different row
  counts (each pads to the longest for the gather)."""
  group = mesh.group
  if group is None:
    return local
  cdev = collective_device(group)
  world = dist.get_world_size(group)
  n = torch.tensor([local.shape[0]], dtype=torch.int64, device=cdev)
  ns = torch.empty(world, dtype=torch.int64, device=cdev)
  dist.all_gather_into_tensor(ns, n, group=group)
  ns = ns.tolist()
  top = max(ns)
  buf = torch.zeros((top,) + tuple(local.shape[1:]), dtype=local.dtype,
                    device=cdev)
  buf[:local.shape[0]] = local
  out = torch.empty((world * top,) + tuple(local.shape[1:]),
                    dtype=local.dtype, device=cdev)
  dist.all_gather_into_tensor(out, buf, group=group)
  return torch.cat([out[r * top:r * top + k] for r, k in enumerate(ns)]
                   ).to(local.device)


def voxel_counts_sharded(binary: bytes, mesh: Optional[Mesh] = None
                         ) -> Optional[dict]:
  """Per-label voxel counts of a flat stream: each shard decodes its
  block and takes the histogram of its pixels' dictionary keys on its
  device, and the shards' histograms are summed (the psum), with no
  host copy of cc. Returns {label: count} of the labels present, or
  None with the reason logged."""
  if mesh is None:
    mesh = make_mesh()
  head = _codec.header(binary)
  if head.label_format != LabelFormat.FLAT:
    return _fallback("voxel_counts_sharded",
                     f"label format {head.label_format} != FLAT")
  uniq, cum, keys = _engine._flat_label_tables(head, binary)
  inputs = _engine.prepare_slice_inputs(binary, 0, head.sz)
  shards = _upload(dict(_crack_rows(inputs), offs=cum[:head.sz]), mesh)
  keys_on = _replicas(keys.astype(np.int64), mesh.devices)
  parts = []
  for (d, _, _, t), (cc, _N) in zip(shards, _decode_ccl(
      shards, head.sx, head.sy, head.crack_format == CrackFormat.PERMISSIBLE)):
    with _on(d):
      parts.append(_key_counts(cc, t["offs"], keys_on[d], len(uniq)))
  counts = _sum(parts, mesh.devices[0])
  return {int(l): int(c) for l, c in zip(uniq.tolist(),
                                         counts.cpu().tolist()) if c > 0}


def compress_sharded(labels, mesh: Optional[Mesh] = None,
                     parallel: int = 0) -> Optional[bytes]:
  """FLAT encode with z blocks sharded over the mesh: each shard runs
  the encode's per-voxel stages (encode._stage1_volume: VCG, first-visit
  CCL, component label tables, per-slice CRC32C, pixel pairs) on its
  own device, and one host tail (encode.assemble_flat_stream: the
  native trace, the dictionary and the byte assembly) splices the
  shards in z order. The bytes equal codec.compress of the same labels.

  labels: (sx, sy, sz) unsigned, a numpy array (each block moves to its
  shard's device) or a tensor on any device (written Fortran-ordered, as
  codec.compress writes a tensor). Returns the .ckl bytes, or None with
  the reason logged where the reference declines: not 3-d, a signed
  dtype, sz 0 or a slice narrower than 2, and a slice the native trace
  cannot take."""
  if mesh is None:
    mesh = make_mesh()
  is_tensor = isinstance(labels, torch.Tensor)
  if not is_tensor:
    labels = np.asarray(labels)
  if labels.ndim != 3:
    return _fallback("compress_sharded", f"ndim={labels.ndim} != 3")
  if (labels.dtype in (torch.int8, torch.int16, torch.int32, torch.int64)
      if is_tensor else np.issubdtype(labels.dtype, np.signedinteger)):
    return _fallback("compress_sharded", "signed dtype")
  sx, sy, sz = labels.shape
  if sz == 0 or sx < 2 or sy < 2:
    return _fallback("compress_sharded",
                     f"degenerate shape {tuple(labels.shape)}")
  if is_tensor:
    zyx = _enc._signed(labels).permute(2, 1, 0)
    width, f_order = labels.element_size(), True
  else:
    zyx = np.transpose(labels, (2, 1, 0))
    width, f_order = labels.dtype.itemsize, bool(labels.flags.f_contiguous)

  blocks = [(d, z0, z1, (zyx[z0:z1].to(d) if is_tensor else
                         _enc._device_labels(zyx[z0:z1], d)).contiguous())
            for d, z0, z1 in _shards(mesh, sz)]
  stage1 = []
  for d, _, _, blk in blocks:
    with _on(d):
      stage1.append(_enc._stage1_volume(blk))
  # the pixel pair across each shard seam, as _stage1_volume adds the
  # pair across each of its batch seams
  pairs = sum(s[4] for s in stage1) + sum(
    int(a[-1, -1, -1]) == int(b[0, 0, 0])
    for (*_, a), (*_, b) in zip(blocks, blocks[1:]))
  tables = np.zeros((sz, max(s[1].shape[1] for s in stage1)), np.uint64)
  for (_, z0, z1, _), s in zip(blocks, stage1):
    tables[z0:z1, :s[1].shape[1]] = s[1]
  packed = _cat([s[0] for s in stage1], mesh.devices[0])
  N = np.concatenate([s[2] for s in stage1])
  crcs = np.concatenate([s[3] for s in stage1])
  del blocks, stage1
  out = _enc.assemble_flat_stream(
    packed, tables, N, crcs, pairs, sx, sy, sz, data_width=width,
    fortran_order=f_order, parallel=parallel)
  if out is None:
    return _fallback("compress_sharded",
                     "native trace unavailable for a slice")
  return out


def sharded_roundtrip_step(mesh: Mesh, sx: int, sy: int,
                           permissible: bool = False):
  """A one-step function of the codec's whole multi-device pattern:
  step(packed, nbytes, nodes, n_chains, keys, offs) -> (cc, counts,
  z_index).

  The arguments are this rank's rows of prepare_slice_inputs (numpy or
  tensors on any device; every row of the window within one process),
  the stream's component -> dictionary keys (all of them, replicated)
  and each row's first component (offs). Each shard decodes its block
  (data parallel over z) and takes the histogram of its pixels' keys;
  the histograms are summed over the shards and the group's ranks (the
  psum), and the rows' byte lengths gathered in z order over the shards
  and ranks (the all_gather of the z index). Returns cc (this rank's
  rows, (B, sy*sx) int32), counts (len(keys),) int64 and z_index (every
  rank's rows) int32, on the mesh's first device."""
  first = mesh.devices[0]

  def step(packed, nbytes, nodes, n_chains, keys, offs):
    k = keys.to(torch.int64) if isinstance(keys, torch.Tensor) else \
      np.asarray(keys).astype(np.int64)
    keys_on = _replicas(k, mesh.devices)
    shards = _upload(dict(packed=packed, nbytes=nbytes, nodes=nodes,
                          n_chains=n_chains, offs=offs), mesh)
    ccs, parts = [], []
    for (d, _, _, t), (cc, _N) in zip(shards, _decode_ccl(
        shards, sx, sy, permissible)):
      with _on(d):
        ccs.append(cc)
        parts.append(_key_counts(cc, t["offs"], keys_on[d], k.shape[0]))
    counts = _all_reduce(_sum(parts, first), mesh)
    z_index = _all_gather(_cat([t["nbytes"] for *_, t in shards], first),
                          mesh)
    return _cat(ccs, first), counts, z_index

  return step
