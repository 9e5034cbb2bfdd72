"""The CUDA kernels against their plain versions, on the card.

These need a CUDA device and skip without one:

  python -m pytest -m cuda tests/test_torch_cuda.py
"""
import functools
import os
import time

import numpy as np
import pytest
import torch

import crackle_tpu as crackle
from crackle_tpu.headers import CrackFormat
import crackle_tpu_torch as ct
from crackle_tpu_torch import operations as tops
from crackle_tpu_torch import parallel as tpar
from crackle_tpu_torch.kernels import _build, ccl, replay, stats
from crackle_tpu_torch.kernels import crc32c as tcrc
from crackle_tpu_torch.kernels import encode as tenc
from crackle_tpu_torch.kernels import engine as teng
from crackle_tpu_torch.ops import analytics as tana

from test_jax_decode import CASES, random_volume
from test_jax_encode import DEVICE_ENCODE_CASES
from test_jax_encode import random_volume as encode_volume
from test_torch_ccl import (hard_vcgs, labels_to_vcg, serpentine_vcg,
                            smooth_labels)
from test_torch_multihost import run_two_ranks
from test_torch_sharding import ENCODES, STREAMS, stream
from test_torch_sharding import encode_volume as sharded_encode_volume
from test_torch_sharding import ref_compress, roundtrip_case
from test_torch_compact import many_closes_inputs
from test_torch_pins import pins_volume
from test_torch_pins_encode import CASES as PINS_CASES
from test_torch_pins_encode import case_volume
from test_torch_replay import islands_volume, random_stream, spiral_volume
from test_torch_seams import SEAMS, edge_plant_inputs, seam_ids
from test_torch_stats import STATS_EDGES, stats_edge_case
from test_torch_window import checkerboard, islands, nuclei_volume

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  return torch.device("cuda")


@pytest.fixture
def numpy_engine():
  """The port's codec on its host engine, so that decompress stays an
  oracle on a machine with a card (auto would send pins, markov and
  label= windows to the card)."""
  from crackle_tpu_torch import codec
  codec.set_engine("numpy")
  yield codec
  codec.set_engine("auto")


def _volumes():
  vols = [random_volume(*c) for c in CASES]
  vols += [random_volume((600, 9, 2), 7, 42, 4), spiral_volume(),
           islands_volume()]
  return vols


def _stages(t, head, cpu):
  """ev, cls, drange, ids, vcg, (cc, N) of one batch, with the kernels
  (cpu=False) or the plain versions on the CPU."""
  if cpu:
    t = {k: v.cpu() for k, v in t.items()}
  perm = head.crack_format == CrackFormat.PERMISSIBLE
  ev, cls, drange = replay.replay_keys(t["packed"], t["nbytes"],
                                       t["n_chains"])
  ids = replay.replay_positions(ev, cls, drange, t["nodes"], head.sx,
                                head.sy)
  vcg = replay.paint_vcg(ids, head.sx, head.sy, perm)
  cc, N, _ = ccl.ccl_paint(vcg)
  return [x.cpu() for x in (ev, cls, drange, ids, vcg, cc, N)]


@pytest.mark.parametrize("tile", [32, 256, 1024])
def test_kernels_match_plain(dev, monkeypatch, tile):
  monkeypatch.setattr(replay, "TILE", tile)
  for vol in _volumes():
    binary = crackle.compress(vol)
    inputs = teng.prepare_slice_inputs(binary, 0, vol.shape[2])
    t = teng.params_from_jax(inputs, device=dev)
    for got, want in zip(_stages(t, inputs["head"], False),
                         _stages(t, inputs["head"], True)):
      assert torch.equal(got, want)


@pytest.mark.parametrize("table", [None, 1, 8])
@pytest.mark.parametrize("tile", [32, 256, 1024])
def test_replay_kernels_on_random_streams(dev, monkeypatch, tile, table):
  """replay_keys and replay_positions bit-equal to their plain versions
  on the seeded random-byte streams, at three tiles, and with the depth
  table shrunk so that slices keep it in the scratch tensor."""
  monkeypatch.setattr(replay, "TILE", tile)
  if table:
    monkeypatch.setattr(replay, "DEPTH_TABLE", table)
  for seed in range(50):
    t, sx, sy = random_stream(seed)
    want = replay.replay_keys(t["packed"], t["nbytes"], t["n_chains"])
    got = replay.replay_keys(*(t[k].to(dev) for k in ("packed", "nbytes",
                                                      "n_chains")))
    torch.cuda.synchronize()
    _equal(got, want)
    ids = replay.replay_positions(*got, t["nodes"].to(dev), sx, sy)
    torch.cuda.synchronize()
    _equal([ids], [replay.replay_positions_plain(*want, t["nodes"], sx,
                                                 sy)])


@pytest.mark.parametrize("sx,sy", [(1024, 1024), (1500, 700)])
def test_paint_vcg_past_one_block(dev, sx, sy):
  """Slices whose edge bitmap passes one block's shared memory paint in
  bands, bit-equal to the plain version: every edge id of the slice,
  none, random ones (some out of range) and a sparse set."""
  assert replay.paint_band_px(sx, sy) < sx * sy
  NB = sy * (sx + 1) + (sy + 1) * sx
  rng = np.random.RandomState(sx)
  ids = np.stack([np.arange(NB), np.full(NB, -1),
                  rng.randint(-5, NB + 5, NB),
                  np.where(rng.rand(NB) < 0.01, rng.randint(0, NB, NB), -1)])
  ids = torch.from_numpy(ids.astype(np.int32))
  for perm in (True, False):
    got = replay.paint_vcg(ids.to(dev), sx, sy, perm)
    torch.cuda.synchronize()
    _equal([got], [replay.paint_vcg_plain(ids, sx, sy, perm)])


def blocky_1024(seed=11):
  """1024^2 x 8 labels: 64-pixel blocks of 40 labels, shifted per
  slice (a smooth volume's boundaries, cheap to compress)."""
  rng = np.random.RandomState(seed)
  blocks = rng.randint(0, 40, (17, 17, 8)).astype(np.uint32)
  vol = np.repeat(np.repeat(blocks, 64, 0), 64, 1)
  for z in range(8):
    vol[:, :, z] = np.roll(vol[:, :, z], (5 * z, 3 * z), (0, 1))
  return np.asfortranarray(vol[:1024, :1024])


@pytest.mark.parametrize("pins", [False, True])
def test_1024_slices_decode_on_card(dev, numpy_engine, pins):
  """A 1024^2 x 8 flat stream and its condensed-pins stream (the port's
  own compress): decode_window with the CRC gate equal to the host
  decoder; the flat one's voxel_counts and bounding_boxes equal to
  numpy's."""
  codec = numpy_engine
  vol = blocky_1024()
  binary = codec.compress(vol, allow_pins=pins)
  assert codec.header(binary).label_format == (2 if pins else 0)
  s = ct.upload_stream(binary, dev)
  assert s is not None
  ct.reset_launches()
  labels, _, _ = s.decode_window(0, 8, check_crcs=True)
  torch.cuda.synchronize()
  assert ct.LAUNCHES["paint_vcg"] == 1
  want = np.ascontiguousarray(codec.decompress(binary).transpose(2, 1, 0))
  np.testing.assert_array_equal(labels.cpu().numpy().reshape(want.shape),
                                want.astype(labels.cpu().numpy().dtype))
  if not pins:
    uniq, counts = np.unique(vol, return_counts=True)
    ct.reset_launches()
    vc = ct.voxel_counts(binary, device=dev)
    assert ct.LAUNCHES["slice_stats"] == 1
    assert {int(u): int(c) for u, c in zip(uniq, counts)} == \
      {int(k): int(v) for k, v in vc.items()}
    bb = ct.bounding_boxes(binary, no_slice_conversion=True, device=dev)
    for u in uniq:
      xs, ys, zs = np.nonzero(vol == u)
      assert [int(v) for v in bb[u]] == [xs.min(), ys.min(), zs.min(),
                                          xs.max(), ys.max(), zs.max()]


def test_corrupt_streams_do_not_fault(dev):
  """Random bytes drive positions far outside the raster; the kernels
  must mask them exactly as the plain versions do."""
  rng = np.random.RandomState(5)
  binary = crackle.compress(random_volume((40, 30, 4), 6, 9, 3))
  inputs = teng.prepare_slice_inputs(binary, 0, 4)
  for _ in range(4):
    bad = dict(inputs)
    bad["packed"] = rng.randint(0, 256, inputs["packed"].shape,
                                dtype=np.uint8)
    bad["nbytes"] = np.full_like(inputs["nbytes"], bad["packed"].shape[1])
    t = teng.params_from_jax(bad, device=dev)
    got = _stages(t, inputs["head"], False)
    torch.cuda.synchronize()
    for g, w in zip(got, _stages(t, inputs["head"], True)):
      assert torch.equal(g, w)

  # the largest CAP on a 40000-wide slice, every codepoint a DOWN move:
  # positions run to CAP * (sx + 1), past 2^32, where an int32 sum
  # would wrap back onto the raster; they must mask to -1 as they do in
  # the plain version's int64
  binary = crackle.compress(random_volume((40000, 2, 1), 3, 9))
  inputs = teng.prepare_slice_inputs(binary, 0, 1)
  packed = np.zeros((1, teng.MAX_DEVICE_CAP // 4), np.uint8)
  packed[0, 0] = 2  # UP -> DOWN, then zero diffs: DOWN throughout
  bad = dict(inputs, packed=packed,
             nbytes=np.array([packed.shape[1]], np.int32))
  assert teng.MAX_DEVICE_CAP * 40001 >= 2 ** 32
  t = teng.params_from_jax(bad, device=dev)
  got = _stages(t, inputs["head"], False)
  torch.cuda.synchronize()
  for g, w in zip(got, _stages(t, inputs["head"], True)):
    assert torch.equal(g, w)


def _compact_stages(t, sx, sy):
  """The compact-cancel kernels on the card, each against its plain
  version on the same inputs, and their edge ids against
  replay_positions'."""
  ev, cls, drange = replay.replay_keys(t["packed"], t["nbytes"],
                                       t["n_chains"])
  dense = replay.cancel_sums(ev, cls, drange)
  torch.cuda.synchronize()
  _equal([dense], [replay.cancel_sums_plain(ev.cpu(), cls.cpu(),
                                            drange.cpu())])
  ccap = replay.close_cap(ev.shape[1], t["nodes"].shape[1])
  tables = replay.compact_closes(dense, ccap)
  torch.cuda.synchronize()
  _equal([tables], [replay.compact_closes_plain(dense.cpu(), ccap)])
  ids = replay.replay_positions_compact(cls, tables, t["nodes"], sx, sy)
  torch.cuda.synchronize()
  _equal([ids], [replay.replay_positions_compact_plain(
    cls.cpu(), tables.cpu(), t["nodes"].cpu(), sx, sy)])
  want = replay.replay_positions(ev, cls, drange, t["nodes"], sx, sy)
  torch.cuda.synchronize()
  _equal([ids], [want])
  return dense


@pytest.mark.parametrize("window", [None, 32, 256])
@pytest.mark.parametrize("table", [None, 1, 8])
@pytest.mark.parametrize("tile", [32, 1024])
def test_compact_kernels_match_plain(dev, monkeypatch, tile, table, window):
  """cancel_sums with its depth tables in shared memory and (shrunk) in
  the scratch tensor, and replay_positions_compact at its default
  window and with windows of 32 and 256 positions (seams every few warp
  steps), bit-equal to their plain versions on the volumes."""
  monkeypatch.setattr(replay, "TILE", tile)
  if table:
    monkeypatch.setattr(replay, "DEPTH_TABLE", table)
  if window:
    monkeypatch.setattr(replay, "COMPACT_WINDOW", window)
  for vol in _volumes():
    inputs = teng.prepare_slice_inputs(crackle.compress(vol), 0,
                                       vol.shape[2])
    head = inputs["head"]
    _compact_stages(teng.params_from_jax(inputs, device=dev), head.sx,
                    head.sy)


@pytest.mark.parametrize("window", [None, 32, 1024])
@pytest.mark.parametrize("table", [None, 1, 8])
def test_compact_kernels_on_random_streams(dev, monkeypatch, table, window):
  """The seeded random-byte streams (CAP 128 to 4096, depth ranges up to
  about CAP / 3, so the 384-entry tables overflow into the scratch
  tensor on some slices even at the default table)."""
  if table:
    monkeypatch.setattr(replay, "DEPTH_TABLE", table)
  if window:
    monkeypatch.setattr(replay, "COMPACT_WINDOW", window)
  for seed in range(50):
    t, sx, sy = random_stream(seed)
    _compact_stages({k: v.to(dev) for k, v in t.items()}, sx, sy)


@pytest.mark.parametrize("B,CAP", [(1, 4096), (64, 4096), (1, 32768),
                                   (64, 32768), (1, 65536), (8, 65536)])
def test_compact_kernels_at_path_shapes(dev, monkeypatch, B, CAP):
  """Random streams at batches of 1 and 64 and at the CAP of a 512^2
  slice (32768) and of the split's pieces (65536), at the default window
  and depth table and with both shrunk."""
  for table, window in ((None, None), (8, 1024)):
    if table:
      monkeypatch.setattr(replay, "DEPTH_TABLE", table)
      monkeypatch.setattr(replay, "COMPACT_WINDOW", window)
    for seed in range(2):
      t, sx, sy = random_stream(seed, B, CAP)
      _compact_stages({k: v.to(dev) for k, v in t.items()}, sx, sy)


def test_compact_replay_takes_any_table_width(dev):
  """replay_positions_compact reads the tables in 16-byte loads: a width
  that is no multiple of 4, and a view 4 bytes into its storage, take
  the same ids."""
  t, sx, sy = random_stream(3, 4, 1024)
  ev, cls, dr = replay.replay_keys(t["packed"], t["nbytes"], t["n_chains"])
  tables = replay.compact_closes_plain(replay.cancel_sums_plain(ev, cls, dr),
                                       1001)
  want = replay.replay_positions_compact_plain(cls, tables, t["nodes"], sx,
                                               sy)
  flat = torch.cat([torch.zeros(1, dtype=torch.int32), tables.reshape(-1)])
  for tab in (tables.to(dev), flat.to(dev)[1:].view(tables.shape)):
    got = replay.replay_positions_compact(cls.to(dev), tab,
                                          t["nodes"].to(dev), sx, sy)
    torch.cuda.synchronize()
    _equal([got], [want])


def test_compact_kernels_on_corrupt_streams(dev):
  """Random bytes, and a stream whose close count passes the compact
  table: ranks past it are dropped, never stored out of bounds."""
  rng = np.random.RandomState(6)
  inputs = teng.prepare_slice_inputs(
    crackle.compress(random_volume((40, 30, 4), 6, 9, 3)), 0, 4)
  for _ in range(4):
    bad = dict(inputs)
    bad["packed"] = rng.randint(0, 256, inputs["packed"].shape,
                                dtype=np.uint8)
    bad["nbytes"] = np.full_like(inputs["nbytes"], bad["packed"].shape[1])
    _compact_stages(teng.params_from_jax(bad, device=dev), 40, 30)
  t = teng.params_from_jax(many_closes_inputs(), device=dev)
  dense = _compact_stages(t, 40, 30)
  assert int(dense[0].max()) >= replay.close_cap(4096, 2)


def compact_edge_case(name):
  """(dense (4, B, CAP) int32, ccap) close records at the compaction
  kernel's seams: its blocks take 1024 slots of a slice. Ranks are a
  prefix count over each slice's close slots, as cancel_sums writes
  them; pos and sums are random."""
  rng = np.random.RandomState(len(name))
  B, CAP, ccap = 3, 4096, 1536
  close = np.zeros((B, CAP), bool)
  if name == "a slice with no closes":
    close[0, rng.rand(CAP) < 0.1] = True
    close[2, ::7] = True  # slice 1 has none
  elif name == "last close in the first chunk":
    close[:, rng.choice(1024, 300, replace=False)] = True
    close[1, 1023] = True
  elif name == "closes across chunk seams":
    for seam in (1024, 2048, 3072):
      close[:, seam - 6:seam + 5] = True
  elif name == "ranks past the table":
    close[0, ::2] = True  # 2048 closes, 512 past the table
    close[1, :ccap + 1] = True
    close[2, rng.rand(CAP) < 0.3] = True
  elif name in ("B = 1", "B = 64"):
    B = 1 if name == "B = 1" else 64
    close = rng.rand(B, CAP) < rng.rand(B, 1) * 0.4
  elif name == "CAP 4098, ccap 1001":  # unaligned rows: 4-byte loads
    B, CAP, ccap = 2, 4098, 1001
    close = rng.rand(B, CAP) < 0.2
  else:
    raise KeyError(name)
  dest = np.where(close, np.cumsum(close, 1) - 1, -1)
  vals = rng.randint(-2 ** 31, 2 ** 31, (3, B, CAP), dtype=np.int64)
  dense = np.concatenate([dest[None], vals]).astype(np.int32)
  return torch.from_numpy(dense), ccap


@pytest.mark.parametrize("name", [
  "a slice with no closes", "last close in the first chunk",
  "closes across chunk seams", "ranks past the table", "B = 1", "B = 64",
  "CAP 4098, ccap 1001"])
def test_compact_closes_at_chunk_seams(dev, name):
  dense, ccap = compact_edge_case(name)
  got = replay.compact_closes(dense.to(dev), ccap)
  torch.cuda.synchronize()
  _equal([got], [replay.compact_closes_plain(dense, ccap)])
  # a view 4 bytes into its storage takes the same answer
  flat = torch.cat([torch.zeros(1, dtype=torch.int32), dense.reshape(-1)])
  view = flat.to(dev)[1:].view(dense.shape)
  _equal([replay.compact_closes(view, ccap)], [got])


def test_compact_path_decodes_on_card(dev, monkeypatch):
  """The compact path through its three kernels, and no sort on it."""
  monkeypatch.setattr(replay, "CANCEL_COMPACT", True)
  binary = crackle.compress(np.concatenate([spiral_volume()] * 2, axis=2))
  sorts = []
  for mod, name in ((torch, "sort"), (replay, "sorted_keys")):
    fn = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name, **k: (
      sorts.append(name), fn(*a, **k))[1])
  ct.reset_launches()
  got = ct.upload_stream(binary, dev).decode_window(0, 2, check_crcs=True)
  torch.cuda.synchronize()
  assert sorts == []
  assert ct.LAUNCHES["replay_positions"] == 0
  for name in ("cancel_sums", "compact_closes", "replay_positions_compact"):
    assert ct.LAUNCHES[name] == 1
  _equal(got, ct.upload_stream(binary, "cpu").decode_window(0, 2))


def test_paint_k2_matches_plain(dev):
  rng = np.random.RandomState(2)
  vcg = torch.from_numpy(
    (rng.randint(0, 16, size=(3, 37, 29)) & 0b1010).astype(np.int32))
  T = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, size=(3, 2, 256),
                                   dtype=np.int64).astype(np.int32))
  got = ccl.ccl_paint(vcg.to(dev), T.to(dev))
  want = ccl.ccl_paint(vcg, T)
  for g, w in zip(got, want):
    assert torch.equal(g.cpu(), w.cpu())


@functools.lru_cache(maxsize=1)
def _ccl_cases():
  """(vcg, cc, N, L, tgt) of the plain versions on the hard topologies,
  random connectivity bits and smooth label slices (some wider than an
  8192-pixel tile), and a 512^2 snake."""
  rng = np.random.RandomState(9)
  vcgs = list(hard_vcgs().values())
  vcgs += [(rng.randint(0, 16, size=(3, sy, sx)) & 0b1010).astype(np.int32)
           for sy, sx in ((37, 29), (64, 100), (1, 5000))]
  vcgs += [labels_to_vcg(smooth_labels(3, sy, sx, 6, sx))
           for sy, sx in ((40, 70), (96, 5000), (130, 130))]
  vcgs.append(serpentine_vcg(1, 512, 512))
  cases = []
  for vcg in map(torch.from_numpy, vcgs):
    cc, N, _ = ccl.ccl_paint_plain(vcg)
    cases.append((vcg, cc, N) + ccl.ccl_min_plain(vcg))
  return cases


@pytest.mark.parametrize("tile", [32, 64, 4096, 8192])
def test_tiled_ccl_matches_plain(dev, monkeypatch, tile):
  """ccl_paint at K = 0, 1, 2 and ccl_min bit-equal to their plain
  versions, with tile seams inside rows, across rows and past sx."""
  monkeypatch.setattr(ccl, "TILE_PIX", tile)
  rng = np.random.RandomState(tile)
  for vcg, cc, N, L, tgt in _ccl_cases():
    _equal(ccl.ccl_paint(vcg.to(dev))[:2], (cc, N))
    for K in (1, 2):
      T = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31,
                                       (vcg.shape[0], K, 256),
                                       dtype=np.int64).astype(np.int32))
      got = ccl.ccl_paint(vcg.to(dev), T.to(dev))
      torch.cuda.synchronize()
      _equal(got, (cc, N, ccl.paint_plain(cc, T)))
    got = ccl.ccl_min(vcg.to(dev))
    torch.cuda.synchronize()
    _equal(got, (L, tgt))


def _equal(got, want):
  got, want = list(got), list(want)
  assert len(got) == len(want)
  for g, w in zip(got, want):
    assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("sy,sx", [(37, 29), (64, 512), (1, 7)])
def test_ccl_min_and_plant_match_plain(dev, sy, sx):
  """ccl_min, then plant at K = 0, 1 and 2 on its roots, bit-equal to
  the plain versions; the composition equals ccl_paint."""
  rng = np.random.RandomState(sy + sx)
  for vcg in (labels_to_vcg(smooth_labels(3, sy, sx, 6, sy)),
              (rng.randint(0, 16, size=(3, sy, sx)) & 0b1010)
              .astype(np.int32)):
    vcg = torch.from_numpy(vcg)
    L, tgt = ccl.ccl_min(vcg.to(dev))
    torch.cuda.synchronize()
    _equal((L, tgt), ccl.ccl_min_plain(vcg))
    cap_n = ccl._pow2_cap(min(int((tgt.max() + 1).item()), 2048))
    roots, N = ccl.roots_from_tgt(tgt, cap_n)
    for K in (0, 1, 2):
      T = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, (3, K, cap_n),
                                       dtype=np.int64).astype(np.int32))
      got = ccl.plant(L, roots, T.to(dev) if K else None)
      torch.cuda.synchronize()
      _equal(got, ccl.plant_plain(L.cpu(), roots.cpu(), T if K else None))
    if int(N.max()) <= cap_n:
      _equal(ccl.ccl_paint_v2(vcg.to(dev), T.to(dev)),
             ccl.ccl_paint(vcg.to(dev), T.to(dev)))


@pytest.mark.parametrize("tile", [None, 32])
@pytest.mark.parametrize("sy,sx", [(37, 29), (64, 512), (1, 7)])
def test_ccl_min_roots_matches_plain(dev, monkeypatch, sy, sx, tile):
  """ccl_min_roots bit-equal to its plain version (ccl_min_plain, then
  roots_from_tgt) with N below, at and past the roots' width; at 32-pixel
  tiles the roots land in many tiles and the last tile, which pads
  them, is not the first."""
  if tile:
    monkeypatch.setattr(ccl, "TILE_PIX", tile)
  rng = np.random.RandomState(sy + sx)
  for vcg in (labels_to_vcg(smooth_labels(3, sy, sx, 6, sy)),
              (rng.randint(0, 16, size=(3, sy, sx)) & 0b1010)
              .astype(np.int32)):
    vcg = torch.from_numpy(vcg)
    n_max = int(ccl.ccl_plain(vcg)[1].max())
    for cap in {ccl._pow2_cap(n_max), n_max, max(n_max // 2, 1), 1}:
      got = ccl.ccl_min_roots(vcg.to(dev), cap)
      torch.cuda.synchronize()
      _equal(got, ccl.ccl_min_roots(vcg, cap))


def test_pins_roots_from_the_rank_pass_at_512(dev, monkeypatch):
  """A 512^3 pins window whose roots come from ccl_min_roots gives the
  labels, cc and N of ccl_min -> roots_from_tgt -> plant."""
  from crackle_tpu_torch import codec
  vol = blocky_volume((512, 512, 512), 23)
  binary = codec.compress(_on_card(vol, dev), allow_pins=1)
  del vol
  assert codec.header(binary).label_format == 2
  st = teng.upload_stream(binary, dev)
  assert st.pins[5] <= ccl.PAINT_CAP_N
  ct.reset_launches()
  got = st.decode_window(0, 512, check_crcs=True)
  assert ct.LAUNCHES["ccl_min_roots"] == 1

  def composed(vcg, cap_n):
    L, tgt = ccl.ccl_min(vcg)
    return (L,) + ccl.roots_from_tgt(tgt, cap_n)

  monkeypatch.setattr(ccl, "ccl_min_roots", composed)
  ct.reset_launches()
  want = st.decode_window(0, 512, check_crcs=True)
  assert ct.LAUNCHES["ccl_min_roots"] == 0
  _equal(got, want)


def test_plant_misses_match_plain(dev):
  """Ids that no root holds, roots padding (n) and ids outside [0, n)
  plant 0 in the kernel as in the plain version."""
  rng = np.random.RandomState(3)
  B, sy, sx, cap_n = 4, 33, 65, 256
  n = sy * sx
  L = torch.from_numpy(rng.randint(-5, n + 5, (B, sy, sx)).astype(np.int32))
  L[0, 0, :4] = n
  roots = np.sort(rng.choice(n, (B, cap_n)), 1).astype(np.int32)
  roots[:, 200:] = n
  roots = torch.from_numpy(roots)
  T = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, (B, 2, cap_n),
                                   dtype=np.int64).astype(np.int32))
  got = ccl.plant(L.to(dev), roots.to(dev), T.to(dev))
  torch.cuda.synchronize()
  _equal(got, ccl.plant_plain(L, roots, T))


def _unaligned(t):
  """A contiguous copy of t whose data starts 4 bytes past a 16-byte
  boundary (the kernels' scalar loads)."""
  flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
  out = flat[1:1 + t.numel()].view(t.shape)
  out.copy_(t)
  assert out.is_contiguous() and out.data_ptr() % 16 == 4
  return out


@pytest.mark.parametrize("sx,sy,layout", [
  (sx, sy, layout) for sx, sy in SEAMS
  for layout in ("grid", "32-pixel bands", "split", "unaligned ids")
  if layout != "split" or sx >= 64])
def test_paint_vcg_band_seams(dev, monkeypatch, sx, sy, layout):
  """The paint kernel at odd widths, bit-equal to its plain version at
  B = 1 and 4, on every edge id of the slice, none, random ones (some
  out of range) and a sparse set: its own grid (more bands than slices
  at B = 1), bands of 32 pixels (PAINT_MIN_BAND shrunk: a seam every 32
  pixels, inside rows and across them), bands under a row (PAINT_SMEM_MAX
  shrunk: split H ranges), and ids 4 bytes off a 16-byte boundary."""
  if layout == "32-pixel bands":
    monkeypatch.setattr(replay, "PAINT_MIN_BAND", 32)
    monkeypatch.setattr(replay, "PAINT_FILL", 1 << 20)
  if layout == "split":
    monkeypatch.setattr(replay, "PAINT_SMEM_MAX", 4 * replay._band_words(
      32 * max(1, sx // 64), sx))
  ids = torch.from_numpy(seam_ids(sx, sy, sx + sy))
  sms = _build.sm_count(dev)
  for B in (1, 4):
    bands, P = replay.paint_grid(B, sx, sy, sms)
    assert B > 1 or bands > B
    assert replay._band_layout(P, sx)[2] == (P < sx)
    assert layout != "split" or P < sx
    if layout == "32-pixel bands":
      assert P == 32
    x = ids[:B].to(dev)
    if layout == "unaligned ids":
      x = _unaligned(x)
    for perm in (True, False):
      ct.reset_launches()
      got = replay.paint_vcg(x, sx, sy, perm)
      torch.cuda.synchronize()
      assert ct.LAUNCHES["paint_vcg"] == 1
      _equal([got], [replay.paint_vcg_plain(ids[:B], sx, sy, perm)])


def test_paint_vcg_grid_fills_the_card(dev):
  """At B = 1 and B = 32 on 512^2 slices the paint's grid holds a block
  an SM or more, and B = 512 takes one band a slice."""
  sms = _build.sm_count(dev)
  for B in (1, 32):
    bands, _ = replay.paint_grid(B, 512, 512, sms)
    assert bands > 1 and bands * B >= sms
  assert replay.paint_grid(512, 512, 512, sms)[0] == 1


@pytest.mark.parametrize("K", [0, 1, 2])
@pytest.mark.parametrize("sy,sx,cap_n,aligned", [
  (33, 65, 256, True), (16, 64, 4096, True), (256, 512, 65536, True),
  (1, 7, 8, True), (64, 64, 512, False), (512, 512, 1024, True)])
def test_plant_edge_ids_match_plain(dev, sy, sx, cap_n, aligned, K):
  """plant bit-equal to its plain version on ids at -1, at n and past
  it, equal to the padding root (n), non-roots and roots, with repeated
  roots; tables past PAINT_CAP_N and past one block's shared memory
  (65536 roots); n a multiple of 4 (16-byte loads and stores) and not,
  L 16-byte aligned and not. The dense map is taken from memory the
  allocator just freed, filled with ranks in [0, cap_n), so an entry no
  root wrote points at a real rank: the kernel must hold it against the
  roots."""
  L, roots, T = edge_plant_inputs(3, sy, sx, cap_n, K, sy + sx + K)
  L, roots = torch.from_numpy(L), torch.from_numpy(roots)
  T = torch.from_numpy(T) if K else None
  want = ccl.plant_plain(L, roots, T)
  Ld = L.to(dev) if aligned else _unaligned(L.to(dev))
  junk = [torch.randint(0, cap_n, (3, sy * sx), dtype=torch.int32,
                        device=dev) for _ in range(4)]
  del junk
  ct.reset_launches()
  got = ccl.plant(Ld, roots.to(dev), T.to(dev) if K else None)
  torch.cuda.synchronize()
  assert ct.LAUNCHES["plant"] == 1
  _equal(got, want)


@pytest.mark.parametrize("sy,sx,cap_n", [(40, 24, 64), (512, 512, 1024),
                                         (8, 1024, 4096), (3, 5, 8)])
def test_slice_stats_match_plain(dev, sy, sx, cap_n):
  """The stats kernel against its plain version on a CCL image, and on
  random ids with some at or past cap_n and some negative."""
  rng = np.random.RandomState(sx)
  cc, _, _ = ccl.ccl_paint_plain(torch.from_numpy(
    labels_to_vcg(smooth_labels(3, sy, sx, 5, sy))))
  noisy = torch.from_numpy(rng.randint(-3, cap_n + 9, (3, sy * sx))
                           .astype(np.int32))
  for ids in (cc, noisy):
    got = stats.slice_stats(ids.to(dev), sx, sy, cap_n)
    torch.cuda.synchronize()
    _equal([got], [stats.slice_stats_plain(ids, sx, sy, cap_n)])


@pytest.mark.parametrize("band_rows", [None, 3, 1])
@pytest.mark.parametrize("name", STATS_EDGES)
def test_slice_stats_at_band_seams(dev, monkeypatch, name, band_rows):
  """The stats kernel against its plain version at the default band and
  at bands of 3 rows and of 1, so that bands end inside components and
  (3 rows) short of the slice's end; see stats_edge_case."""
  cc, sx, sy, cap_n = stats_edge_case(name)
  if band_rows:
    monkeypatch.setattr(stats, "BAND_PX", band_rows * sx)
  got = stats.slice_stats(cc.to(dev), sx, sy, cap_n)
  torch.cuda.synchronize()
  _equal([got], [stats.slice_stats_plain(cc, sx, sy, cap_n)])
  # a view 4 bytes into its storage takes the same answer
  flat = torch.cat([torch.zeros(1, dtype=torch.int32), cc.reshape(-1)])
  _equal([stats.slice_stats(flat.to(dev)[1:].view(cc.shape), sx, sy,
                            cap_n)], [got])


def test_pins_stream_matches_cpu(dev):
  """A condensed-pins stream decodes on the card as on the CPU; under
  recording() the window's 10 slices count as pins_roots_fused inside
  decode.pins_ccl, with one ccl_min_roots launch."""
  from crackle_tpu_torch.utils import profiling
  binary = crackle.compress(pins_volume(), allow_pins=1)
  assert crackle.header(binary).label_format == 2
  st = ct.upload_stream(binary, dev)
  ct.reset_launches()
  with profiling.recording():
    got = st.decode_window(0, 10, check_crcs=True)
  assert ct.LAUNCHES["ccl_min_roots"] == 1 and ct.LAUNCHES["plant"] == 2
  assert ct.LAUNCHES["ccl_min"] == 0
  (s,) = [s for s in profiling.spans() if s.name == "decode.pins_ccl"]
  assert s.counters == {"pins_roots_fused": 10}
  _equal(got, ct.upload_stream(binary, "cpu").decode_window(0, 10))


def test_slice_stats_exact_past_2_24(dev):
  """Int64 sums on the card: the x-sum 66,977,791 is exact."""
  cc = torch.zeros((1, 512 * 512), dtype=torch.int32)
  cc[0, 1] = 1
  got = stats.slice_stats(cc.to(dev), 512, 512, 8)
  torch.cuda.synchronize()
  assert got[0, 0, :3].tolist() == [512 * 512 - 1, 66_977_791, 66_977_792]
  _equal([got], [stats.slice_stats_plain(cc, 512, 512, 8)])


@pytest.mark.parametrize("name", ["islands", "nuclei"])
def test_split_on_card(dev, monkeypatch, numpy_engine, name):
  """Slices past MAX_DEVICE_CAP (1024 here) split into pieces of at most
  SPLIT_TARGET_CPS (512 here) codepoints: decode_window_ccl_device's cc
  and N on the card equal the CPU's, and decode_window with the CRC gate
  equals the host decoder."""
  monkeypatch.setattr(teng, "MAX_DEVICE_CAP", 1024)
  monkeypatch.setattr(teng, "SPLIT_TARGET_CPS", 512)
  vol = islands(4, 96) if name == "islands" else nuclei_volume(512, 512, 6)
  sz = vol.shape[2]
  binary = numpy_engine.compress(vol)
  _, piece_z = teng.prepare_split_inputs(binary, 0, sz)
  assert len(piece_z) > sz
  ct.reset_launches()
  cc, N, _ = ct.decode_window_ccl_device(binary, 0, sz, dev)
  torch.cuda.synchronize()
  assert ct.LAUNCHES["paint_vcg"] == 1 and ct.LAUNCHES["ccl_paint"] == 1
  wcc, wN, _ = ct.decode_window_ccl_device(binary, 0, sz, "cpu")
  _equal([cc, N], [wcc, wN])
  got = ct.decode_window(binary, 0, sz, check_crcs=True, device=dev)
  np.testing.assert_array_equal(got, numpy_engine.decompress(binary))
  np.testing.assert_array_equal(got, vol)


def test_gather_paint_on_card(dev, numpy_engine):
  """7,680 components a slice, past PAINT_CAP_N: decode_window_device
  takes the gather paint on the card, equal to the CPU's."""
  vol = checkerboard((96, 80, 3))
  binary = numpy_engine.compress(vol)
  got = ct.decode_window_device(binary, 0, 3, dev)
  assert int(got[2].min()) == 96 * 80 > ccl.PAINT_CAP_N
  _equal(got[:3], ct.decode_window_device(binary, 0, 3, "cpu")[:3])
  np.testing.assert_array_equal(
    ct.decode_window(binary, 1, 3, device=dev), vol[:, :, 1:])


@pytest.mark.parametrize("name", ["u64", "pins", "nuclei split"])
def test_label_masks_on_card(dev, monkeypatch, numpy_engine, name):
  """label= masks of decode_window and of codec.decompress under
  set_engine('torch') against decompress on the host engine, for two
  present labels and an absent one; pins queries stay on the host."""
  codec = numpy_engine
  if name == "nuclei split":
    monkeypatch.setattr(teng, "MAX_DEVICE_CAP", 4096)
    vol = nuclei_volume(256, 256, 5)
  elif name == "pins":
    vol = pins_volume()
  else:
    vol = random_volume((64, 48, 6), 9, 7, 4)
  if name == "u64":
    vol = np.asfortranarray(vol.astype(np.uint64) + np.uint64(1 << 40))
  binary = codec.compress(vol, allow_pins=name == "pins")
  assert (codec.header(binary).label_format == 2) == (name == "pins")
  sz = vol.shape[2]
  uniq = np.unique(vol)
  for label in (int(uniq[1]), int(uniq[-1]), int(uniq[-1]) + 1):
    want = codec.decompress(binary, label=label)
    got = ct.decode_window(binary, 0, sz, label=label, device=dev)
    if name == "pins":
      assert got is None
    else:
      np.testing.assert_array_equal(got, want)
    codec.set_engine("torch", device=dev)
    try:
      np.testing.assert_array_equal(codec.decompress(binary, label=label),
                                    want)
    finally:
      codec.set_engine("numpy")


def _on_card(vol, dev):
  """An unsigned numpy volume as a tensor of its dtype on the card."""
  signed = {2: np.int16, 4: np.int32, 8: np.int64}
  unsigned = {2: torch.uint16, 4: torch.uint32, 8: torch.uint64}
  k = vol.dtype.itemsize
  if k == 1:
    return torch.from_numpy(vol).to(dev)
  return torch.from_numpy(vol.view(signed[k])).to(dev).view(unsigned[k])


@pytest.mark.parametrize("shape,nl,seed,smooth,dtype", DEVICE_ENCODE_CASES)
def test_encode_on_card_matches_host(dev, numpy_engine, shape, nl, seed,
                                     smooth, dtype):
  """compress of a tensor on the card, and encode_flat_device of numpy
  input in F and C order, against the port's host compress."""
  codec = numpy_engine
  vol = encode_volume(shape, nl, seed, smooth, dtype)
  want = codec.compress(vol)
  ct.reset_launches()
  assert codec.compress(_on_card(vol, dev)) == want
  assert ct.LAUNCHES["ccl_paint"] == 1
  assert tenc.encode_flat_device(vol, device=dev) == want
  c = np.ascontiguousarray(vol)
  assert tenc.encode_flat_device(c, fortran_order=False, device=dev) == \
    codec.compress(c)


@pytest.mark.parametrize("kind,args,dtype", PINS_CASES)
def test_pins_encode_on_card_matches_host(dev, numpy_engine, kind, args,
                                          dtype):
  """compress(..., allow_pins=1) of a tensor on the card, with the pins'
  column scan and cover index on the card, and encode_pins_device of
  numpy input, against the port's host encoder."""
  codec = numpy_engine
  vol = case_volume(kind, args, dtype)
  want = codec.compress(vol, allow_pins=1)
  assert codec.header(want).label_format == 2
  ct.reset_launches()
  assert codec.compress(_on_card(vol, dev), allow_pins=1) == want
  assert ct.LAUNCHES["ccl_paint"] == 1
  assert tenc.encode_pins_device(vol, device=dev) == want


def test_pins_encode_of_wide_slices_on_card(dev, numpy_engine):
  """512^2 slices, 16 deep, of 8 x 8 x 4 blocks of 40 labels with ragged
  edges: tens of thousands of components and pins, past the tests' CPU
  sizes."""
  rng = np.random.RandomState(41)
  coarse = rng.randint(0, 40, (64, 64, 4)).astype(np.uint32)
  vol = np.repeat(np.repeat(np.repeat(coarse, 8, 0), 8, 1), 4, 2)
  for _ in range(4):
    axis = rng.randint(0, 3)
    vol = np.where(rng.rand(*vol.shape) < 0.5, np.roll(vol, 1, axis=axis),
                   vol)
  vol = np.asfortranarray(vol)
  want = numpy_engine.compress(vol, allow_pins=1)
  assert numpy_engine.header(want).label_format == 2
  assert numpy_engine.compress(_on_card(vol, dev), allow_pins=1) == want


def test_pins_compress_on_card_raises_where_encode_fails(dev, numpy_engine,
                                                         monkeypatch):
  """Labels on the card never go to the host pins encoder: a decline or
  a trace that overflows raises with the reason."""
  vol = case_volume(*PINS_CASES[2])
  monkeypatch.setattr(tenc, "_trace", lambda *a, **k: None)
  with pytest.raises(RuntimeError, match="the native trace overflowed"):
    numpy_engine.compress(_on_card(vol, dev), allow_pins=1)
  monkeypatch.setattr(tenc.native, "available", lambda: False)
  with pytest.raises(RuntimeError, match="native trace library is missing"):
    numpy_engine.compress(_on_card(vol, dev), allow_pins=1)


def test_encode_1024_slices_on_card(dev, numpy_engine):
  """1024^2 slices, past the reference's VMEM limit: 64-pixel blocks of
  40 labels, shifted per slice, with scattered single pixels."""
  rng = np.random.RandomState(74)
  blocks = rng.randint(0, 40, (17, 17, 4)).astype(np.uint32)
  vol = np.repeat(np.repeat(blocks, 64, 0), 64, 1)[:1024, :1024]
  for z in range(4):
    vol[:, :, z] = np.roll(vol[:, :, z], (5 * z, 3 * z), (0, 1))
  dots = rng.rand(*vol.shape) < 0.001
  vol[dots] = rng.randint(0, 40, int(dots.sum()))
  vol = np.asfortranarray(vol)
  assert numpy_engine.compress(_on_card(vol, dev)) == \
    numpy_engine.compress(vol)


@pytest.mark.parametrize("tile", [32, 8192])
def test_encode_at_ccl_tiles(dev, numpy_engine, monkeypatch, tile):
  monkeypatch.setattr(ccl, "TILE_PIX", tile)
  vol = encode_volume((300, 77, 5), 6, 71, 3)
  t = _on_card(vol, dev)
  zyx = t.permute(2, 1, 0)
  for got, want in zip(tenc.ccl_from_labels(zyx),
                       tenc.ccl_from_labels(zyx.cpu())):
    assert torch.equal(got.cpu(), want)
  assert numpy_engine.compress(t) == numpy_engine.compress(vol)


def test_encode_of_a_decoded_window_takes_no_copy(dev, numpy_engine,
                                                  monkeypatch):
  """The (B, sy*sx) labels of DeviceStream.decode_window, reshaped and
  permuted to (sx, sy, B), reach stage 1 as they lie, and encode to the
  stream's own bytes."""
  vol = encode_volume((40, 33, 6), 5, 72, 3)
  binary = numpy_engine.compress(vol)
  labels, _, _ = ct.upload_stream(binary, dev).decode_window(0, 6)
  seen = []
  stage1 = tenc._stage1_volume

  def spy(zyx):
    seen.append(zyx.data_ptr())
    return stage1(zyx)

  monkeypatch.setattr(tenc, "_stage1_volume", spy)
  assert numpy_engine.compress(
    labels.reshape(6, 33, 40).permute(2, 1, 0)) == binary
  assert seen == [labels.data_ptr()]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.uint64])
def test_encode_of_a_c_order_tensor_on_card(dev, numpy_engine, dtype):
  """A tensor in torch's default C order: its (z, y, x) view is copied on
  the card through the signed view, and the bytes are those of the host
  compress of the same labels in F order (the tensor's header order)."""
  vol = encode_volume((37, 29, 5), 6, 75, 3, np.uint64)
  vol = (vol * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(
    64 - 8 * np.dtype(dtype).itemsize)
  vol = np.ascontiguousarray(vol.astype(dtype))
  t = _on_card(vol, dev)
  assert t.is_contiguous() and not t.permute(2, 1, 0).is_contiguous()
  ct.reset_launches()
  assert numpy_engine.compress(t) == \
    numpy_engine.compress(np.asfortranarray(vol))
  assert ct.LAUNCHES["ccl_paint"] == 1


def test_compress_on_card_raises_where_encode_declines(dev, numpy_engine,
                                                        monkeypatch):
  """Labels on the card never go to the host encoder through a decline."""
  with pytest.raises(RuntimeError, match="float32, not unsigned"):
    numpy_engine.compress(torch.zeros((4, 4, 2), device=dev))
  monkeypatch.setattr(tenc.native, "available", lambda: False)
  with pytest.raises(RuntimeError, match="native trace library is missing"):
    numpy_engine.compress(torch.zeros((4, 4, 2), dtype=torch.uint8,
                                      device=dev))


@pytest.mark.parametrize("slices", [1, 3, 8])
def test_encode_launches_ccl_paint_per_batch(dev, numpy_engine, monkeypatch,
                                             slices):
  vol = encode_volume((50, 40, 8), 5, 73, 3, np.uint64)
  monkeypatch.setattr(tenc, "STAGE1_PIX", slices * 50 * 40)
  ct.reset_launches()
  got = numpy_engine.compress(_on_card(vol, dev))
  assert ct.LAUNCHES["ccl_paint"] == -(-8 // slices)
  assert got == numpy_engine.compress(vol)


def test_make_mesh_takes_every_card(dev):
  m = tpar.make_mesh()
  assert m.devices == tuple(torch.device("cuda", i)
                            for i in range(torch.cuda.device_count()))
  assert tpar.make_mesh(["cuda"]).devices == (
    torch.device("cuda", torch.cuda.current_device()),)


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("name", list(STREAMS))
def test_sharded_decode_on_card(dev, numpy_engine, shards, name):
  """decompress_sharded on a mesh of shards on the card, against the host
  codec; each shard launches each kernel of its path."""
  vol, binary = stream(name)
  ct.reset_launches()
  got = tpar.decompress_sharded(binary, tpar.make_mesh([dev] * shards))
  np.testing.assert_array_equal(got, numpy_engine.decompress(binary))
  np.testing.assert_array_equal(got, vol)
  per_shard = {"replay_keys": 1, "replay_positions": 1, "paint_vcg": 1}
  per_shard.update({"ccl_min_roots": 1, "plant": 2}
                   if crackle.header(binary).label_format == 2
                   else {"ccl_paint": 1})
  assert {k: v for k, v in ct.LAUNCHES.items() if v} == {
    k: shards * v for k, v in per_shard.items()}


@pytest.mark.parametrize("shards", [1, 2])
def test_sharded_decode_of_whole_long_slices_on_card(dev, numpy_engine,
                                                     shards):
  """2048^2 slices past MAX_DEVICE_CAP, which the sharded decode takes
  whole (as the reference's does): equal to the host codec."""
  vol = nuclei_volume(2048, 2048, 2)
  binary = numpy_engine.compress(vol)
  assert not teng._device_cap_ok(teng.prepare_slice_inputs(binary, 0, 2))
  got = tpar.decompress_sharded(binary, tpar.make_mesh([dev] * shards))
  np.testing.assert_array_equal(got, vol)


@pytest.mark.parametrize("shards", [1, 3])
def test_sharded_counts_and_step_on_card(dev, shards):
  vol, binary, head, inputs, keys, offs, (rcc, rcounts, rz) = \
    roundtrip_case()
  m = tpar.make_mesh([dev] * shards)
  uniq, counts = np.unique(vol, return_counts=True)
  assert tpar.voxel_counts_sharded(binary, m) == dict(
    zip(uniq.tolist(), counts.tolist()))
  step = tpar.sharded_roundtrip_step(m, 8, 8,
                                     permissible=head.crack_format == 1)
  cc, counts, z_index = step(inputs["packed"], inputs["nbytes"],
                             inputs["nodes"], inputs["n_chains"], keys, offs)
  assert cc.device.type == "cuda"
  np.testing.assert_array_equal(cc.cpu().numpy(), rcc)
  np.testing.assert_array_equal(counts.cpu().numpy(), rcounts)
  np.testing.assert_array_equal(z_index.cpu().numpy(), rz)


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("i", range(len(ENCODES)))
def test_compress_sharded_on_card(dev, numpy_engine, shards, i):
  vol = sharded_encode_volume(ENCODES[i])
  want, _ = ref_compress(i)
  m = tpar.make_mesh([dev] * shards)
  ct.reset_launches()
  assert tpar.compress_sharded(_on_card(vol, dev), m) == want
  assert ct.LAUNCHES["ccl_paint"] == min(shards, vol.shape[2])
  assert tpar.compress_sharded(vol, m) == want


def test_one_rank_nccl_group_on_card(dev):
  """sharded_roundtrip_step with a one-rank nccl group: the all_reduce
  and all_gather_into_tensor go through NCCL on the card."""
  import socket
  import torch.distributed as dist
  vol, binary, head, inputs, keys, offs, (rcc, rcounts, rz) = \
    roundtrip_case()
  s = socket.socket()
  s.bind(("localhost", 0))
  port = s.getsockname()[1]
  s.close()
  dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                          world_size=1, rank=0)
  try:
    m = tpar.make_mesh([dev] * 2, group=dist.group.WORLD)
    assert tpar.sharding.collective_device(m.group).type == "cuda"
    step = tpar.sharded_roundtrip_step(m, 8, 8,
                                       permissible=head.crack_format == 1)
    cc, counts, z_index = step(inputs["packed"], inputs["nbytes"],
                               inputs["nodes"], inputs["n_chains"], keys,
                               offs)
    np.testing.assert_array_equal(counts.cpu().numpy(), rcounts)
    np.testing.assert_array_equal(z_index.cpu().numpy(), rz)
    np.testing.assert_array_equal(cc.cpu().numpy(), rcc)
  finally:
    dist.destroy_process_group()


def test_two_process_gloo_run_on_card(dev):
  run_two_ranks(str(dev))


def snake_volume(sx, sy, sz):
  """Label 1 a serpentine through every other row, joined at the ends
  in turn (one component a slice), label 2 between its rows; each slice
  shifted by its z."""
  a = np.full((sy, sx), 2, np.uint32)
  a[::2] = 1
  a[1::4, -1] = 1
  a[3::4, 0] = 1
  vol = np.stack([np.roll(a, z, 1) for z in range(sz)], axis=2)
  return np.asfortranarray(vol.transpose(1, 0, 2))


def _host_and_card(codec, dev, fn):
  """fn() under the host engine and under set_engine('torch') on dev."""
  want = fn()
  codec.set_engine("torch", device=dev)
  try:
    got = fn()
  finally:
    codec.set_engine("numpy")
  return got, want


@pytest.mark.parametrize("name", ["snake", "checkerboard", "permissible",
                                  "nuclei split"])
def test_vcg_window_on_card(dev, monkeypatch, numpy_engine, name):
  """decode_window_vcg_device on the card equals the host VCG of each
  slice, and voxel_connectivity_graph (4 and 6) under
  set_engine('torch') the host loop, with no window declined."""
  codec = numpy_engine
  if name == "snake":
    vol = snake_volume(300, 200, 4)
  elif name == "checkerboard":
    vol = checkerboard((96, 80, 3))
  elif name == "permissible":
    vol = random_volume((128, 96, 4), 3, 2, 0)
  else:
    monkeypatch.setattr(teng, "MAX_DEVICE_CAP", 4096)
    vol = nuclei_volume(256, 256, 5)
  binary = codec.compress(vol)
  assert (codec.header(binary).crack_format == CrackFormat.PERMISSIBLE) \
    == (name in ("permissible", "checkerboard"))
  sz = vol.shape[2]
  ct.reset_launches()
  vcg = ct.decode_window_vcg_device(binary, 0, sz, dev)
  torch.cuda.synchronize()
  assert ct.LAUNCHES["paint_vcg"] == 1 and ct.LAUNCHES["ccl_paint"] == 0
  for z in range(sz):
    np.testing.assert_array_equal(vcg[z].to(torch.uint8).cpu().numpy()
                                  .ravel(), codec.decode_slice_vcg(binary, z))
  for c in (4, 6):
    got, want = _host_and_card(
      codec, dev, lambda: tops.voxel_connectivity_graph(binary, c))
    np.testing.assert_array_equal(got, want)


def test_vcg_and_contacts_z_seam_on_card(dev, monkeypatch, numpy_engine):
  """Windows of 3 slices over 8: the 6-connected z bits and the z
  contacts across each window seam equal the host loop's."""
  monkeypatch.setattr(tana, "_DEVICE_WINDOW", 3)
  vol = random_volume((64, 48, 8), 6, 5, 6)
  binary = numpy_engine.compress(vol)
  got, want = _host_and_card(
    numpy_engine, dev, lambda: tops.voxel_connectivity_graph(binary, 6))
  np.testing.assert_array_equal(got, want)
  got, want = _host_and_card(
    numpy_engine, dev, lambda: tops.contacts(binary, (4, 4, 40)))
  assert got == want


@pytest.mark.parametrize("top", [2 ** 63 - 3, 2 ** 64 - 9])
def test_contacts_of_u64_labels_on_card(dev, numpy_engine, top):
  """Labels at and past 2^63 beside small ones and background 0: the
  contacts on the card equal the host loop's, unsigned order kept."""
  vol = random_volume((40, 36, 5), 6, 8, 3).astype(np.uint64)
  vol = np.asfortranarray(np.where(vol >= 3, vol + np.uint64(top), vol))
  binary = numpy_engine.compress(vol)
  got, want = _host_and_card(
    numpy_engine, dev, lambda: tops.contacts(binary, (0.3, 0.7, 1.1)))
  assert got == want and len(want) > 3
  assert max(b for _, b in want) >= 2 ** 63


def _kernel_names_in(log_dir):
  """The names of the events of the Chrome trace trace() wrote."""
  import glob
  import json
  import os
  (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
  with open(path) as f:
    return [e.get("name", "") for e in json.load(f)["traceEvents"]]


def _edit(arr, vol):
  """An array over a box, then an int over whole slices (the
  reference's __setitem__ takes an int over whole slices only)."""
  arr[20:50, :, 2:5] = vol[20:50, :, 7:10]
  arr[:, :, 9:11] = 7


@pytest.mark.parametrize("name", ["flat", "pins"])
def test_crackle_array_on_card(dev, numpy_engine, name):
  """CrackleArray cutouts and edits under set_engine('torch'): the host
  engine's arrays and bytes, with the decode kernels launched; the
  statistics on the card (pins streams: the host loop, and no edit, as
  zsplit takes none)."""
  vol = random_volume((96, 64, 12), 3, 3, 60)
  binary = numpy_engine.compress(vol, allow_pins=(name == "pins"))
  assert numpy_engine.header(binary).label_format == (2 if name == "pins"
                                                      else 0)
  keys = [np.s_[:, :, :], np.s_[10:70, 5:60, 3:9], np.s_[:, :, 4],
          np.s_[:, :, ::3]]
  want = [ct.CrackleArray(binary)[k] for k in keys]
  host = ct.CrackleArray(binary)
  if name == "flat":
    _edit(host, vol)
  vc = host.voxel_counts()
  numpy_engine.set_engine("torch", device=dev)
  try:
    arr = ct.CrackleArray(binary)
    ct.reset_launches()
    for k, w in zip(keys, want):
      np.testing.assert_array_equal(arr[k], w)
    assert ct.LAUNCHES["replay_keys"] > 0
    assert ct.LAUNCHES["ccl_paint" if name == "flat" else "ccl_min_roots"] > 0
    if name == "flat":
      _edit(arr, vol)
      assert arr.binary == host.binary
    else:
      with pytest.raises(ValueError):
        _edit(arr, vol)
    ct.reset_launches()
    assert arr.voxel_counts() == vc
    assert ct.LAUNCHES["slice_stats"] == (name == "flat")
  finally:
    numpy_engine.set_engine("numpy")


def test_remote_array_slices_on_card(dev, numpy_engine, tmp_path):
  """CrackleRemoteArray slices of a file under set_engine('torch'): each
  one-slice stream it builds passes the CRC gate on the card."""
  vol = random_volume((96, 64, 9), 3, 4, 60)
  binary = numpy_engine.compress(vol)
  path = str(tmp_path / "v.ckl")
  with open(path, "wb") as f:
    f.write(binary)
  numpy_engine.set_engine("torch", device=dev)
  try:
    remote = ct.CrackleRemoteArray(path)
    ct.reset_launches()
    for z in (0, 4, 8):
      np.testing.assert_array_equal(remote[z], vol[:, :, z])
    assert ct.LAUNCHES["ccl_paint"] == 3
  finally:
    numpy_engine.set_engine("numpy")


def test_cli_decodes_and_encodes_on_card(dev, numpy_engine, tmp_path,
                                         monkeypatch):
  """The command line with the codec's engine at its default ('auto')
  decodes and encodes a flat stream on the card: -d -k launches the
  decode kernels, the compress of its .npy ccl_paint, and the bytes
  equal the host engine's."""
  from click.testing import CliRunner
  from crackle_tpu_torch import cli
  vol = random_volume((96, 64, 7), 3, 4, 60)
  binary = numpy_engine.compress(vol)
  (tmp_path / "v.ckl").write_bytes(binary)
  monkeypatch.chdir(tmp_path)
  numpy_engine.set_engine("auto")
  ct.reset_launches()
  res = CliRunner().invoke(cli.main, ["-d", "-k", "v.ckl"])
  assert res.exit_code == 0, res.output
  assert ct.LAUNCHES["replay_keys"] and ct.LAUNCHES["ccl_paint"]
  got = np.load(tmp_path / "v.npy")
  np.testing.assert_array_equal(got, vol)
  (tmp_path / "v.ckl").unlink()
  ct.reset_launches()
  res = CliRunner().invoke(cli.main, ["-k", "v.npy"])
  assert res.exit_code == 0, res.output
  assert ct.LAUNCHES["ccl_paint"]
  assert numpy_engine.get_engine() == "auto"
  numpy_engine.set_engine("numpy")
  assert (tmp_path / "v.ckl").read_bytes() == numpy_engine.compress(got)


def test_trace_names_the_launched_kernels(dev, numpy_engine, tmp_path):
  """trace() on the card: the exported trace names every kernel that
  LAUNCHES counted for a cutout, and the annotate span."""
  from crackle_tpu_torch.utils import profiling
  vol = random_volume((96, 64, 6), 3, 5, 60)
  binary = numpy_engine.compress(vol)
  numpy_engine.set_engine("torch", device=dev)
  try:
    arr = ct.CrackleArray(binary)
    arr[:, :, 0:2]
    cut = profiling.annotate("cutout")(lambda: arr[:, :, 1:5])
    ct.reset_launches()
    with profiling.trace(str(tmp_path)):
      got = cut()
    launched = [k for k, v in ct.LAUNCHES.items() if v]
  finally:
    numpy_engine.set_engine("numpy")
  np.testing.assert_array_equal(got, vol[:, :, 1:5])
  names = _kernel_names_in(str(tmp_path))
  assert "cutout" in names
  assert launched
  from test_torch_util import device_kernels
  DEVICE_KERNELS = device_kernels()
  for k in launched:
    assert any(f"{d}_kernel" in n for d in DEVICE_KERNELS[k]
               for n in names), k


def blocky_volume(shape, seed):
  """Labels constant on boxes of about 16 x 16 x 4 voxels, each of a
  random label: some 1000 components a slice."""
  rng = np.random.RandomState(seed)
  idx = [np.cumsum(rng.rand(n) < 1 / w) for n, w in zip(shape, (16, 16, 4))]
  lab = rng.randint(0, 2 ** 31, size=[int(i[-1]) + 1 for i in idx])
  return np.asfortranarray(lab[np.ix_(*idx)].astype(np.uint32))


def test_spans_count_every_host_sync(dev, numpy_engine, monkeypatch):
  """A resident decode and a codec.decompress of a 512^2 x 64 stream on
  the card: the host_syncs their spans count are at least the waits
  torch's sync debug mode reports, and the CRC gate's span inside a
  resident decode of the window times the gate within 10% of CUDA events
  around the same call. The card is kept busy while the host enters the
  gate, as the window's replay keeps it, so that neither start event
  waits for the host's set-up of the gate. The gate's wait leaves the
  card idle, so each end event is stamped when the host records it: the
  outer one after the span's, by the host's return from the gate (15-45
  us of a gate of some 0.1 ms on an H100's host), which the host's clock
  measures from the span's end and the outer time leaves out."""
  import warnings
  from crackle_tpu_torch.utils import profiling
  vol = blocky_volume((512, 512, 64), 17)
  binary = numpy_engine.compress(vol)
  stream = teng.upload_stream(binary, dev)
  numpy_engine.set_engine("torch", device=dev)

  def resident():
    stream.decode_window(0, 64, check_crcs=True)

  def decompress():
    assert numpy_engine.decompress(binary).shape == vol.shape

  try:
    np.testing.assert_array_equal(numpy_engine.decompress(binary), vol)
    for fn in (resident, decompress):
      fn()
      torch.cuda.synchronize(dev)
      with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
          with profiling.recording():
            fn()
        finally:
          torch.cuda.set_sync_debug_mode("default")
      waits = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
               if "called a synchronizing" in str(w.message)]
      counted = sum(s.counters.get("host_syncs", 0)
                    for s in profiling.spans())
      assert waits and counted >= len(waits), (fn.__name__, counted, waits)
    gate_fn, events = teng.crc_gate, []

    def timed_gate(cc, stored, z_start):
      on = torch.cuda.current_stream(dev)
      a = torch.cuda.Event(enable_timing=True)
      b = torch.cuda.Event(enable_timing=True)
      torch.cuda._sleep(1 << 20)  # some 0.5 ms of the card
      a.record(on)
      gate_fn(cc, stored, z_start)
      returned = time.perf_counter_ns()
      b.record(on)
      events.append((a, b, returned))

    monkeypatch.setattr(teng, "crc_gate", timed_gate)
    gate, ended = [], []
    for _ in range(5):
      with profiling.recording():
        stream.decode_window(0, 64, check_crcs=True)
      (s,) = [s for s in profiling.spans() if s.name == "engine.crc_gate"]
      gate.append(s.device_ms)
      ended.append(s.end_ns)
    torch.cuda.synchronize(dev)
    outer = [a.elapsed_time(b) - (returned - end) * 1e-6
             for (a, b, returned), end in zip(events, ended)]
    assert len(outer) == 5
    assert abs(np.median(gate) - np.median(outer)) <= 0.1 * np.median(
      outer), (gate, outer)
  finally:
    numpy_engine.set_engine("numpy")


# (B, W) of the CRC kernel's tests: the widths of a slice from one word
# to past 2^19, at one, a few and a window of slices (600001 words only
# at few), and a batch of small slices
CRC_SHAPES = [(B, W) for W in (1, 3, 129, 511, 512, 513, 4096, 262144,
                               600001)
              for B in (1, 7, 512) if not (W == 600001 and B == 512)]
CRC_SHAPES.append((1024, 64))


def _crc_words(B, W, seed):
  """Random (B, W) int32 words, negative ones included, on the host."""
  rng = np.random.RandomState(seed)
  return rng.randint(0, 2 ** 32, size=(B, W), dtype=np.uint32).view(np.int32)


def _crc_reference(words):
  """The reference's lib.crc32c of each row, up to 2^16 words; past
  that, the port's copy of it, whose native CRC stands in for the
  per-byte Python loop the reference takes without google_crc32c (about
  a second a MB)."""
  if words.size <= 1 << 16:
    crc32c = crackle.lib.crc32c
  else:
    from crackle_tpu_torch.lib import crc32c
  return np.array([crc32c(row) for row in words], np.int64)


@pytest.mark.parametrize("B,W", CRC_SHAPES)
def test_crc32c_kernel_matches_reference(dev, B, W):
  words = _crc_words(B, W, B * 1000003 + W)
  t = torch.from_numpy(words).to(dev)
  want = _crc_reference(words)
  _build.reset_launches()
  got = tcrc.crc32c_rows(t)
  assert _build.LAUNCHES["crc32c_rows"] == 1
  assert got.dtype == torch.int64 and got.device == t.device
  np.testing.assert_array_equal(got.cpu().numpy(), want)
  np.testing.assert_array_equal(tcrc.crc32c_rows_plain(t).cpu().numpy(),
                                want)


@pytest.mark.parametrize("W", [4096, 513])
def test_crc32c_kernel_reads_unaligned_rows(dev, W):
  """Rows that do not start on 16 bytes take the kernel's word loads."""
  words = _crc_words(7, W, W)
  buf = torch.zeros(7 * W + 1, dtype=torch.int32, device=dev)
  t = buf[1:].view(7, W)
  t.copy_(torch.from_numpy(words))
  assert t.data_ptr() % 16
  np.testing.assert_array_equal(tcrc.crc32c_rows(t).cpu().numpy(),
                                _crc_reference(words))


@pytest.fixture(scope="module")
def crc_window():
  """A 512^2 x 64 window of random words on the card and its CRCs."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  words = torch.from_numpy(_crc_words(64, 512 * 512, 64)).cuda()
  return words, tcrc.crc32c_rows(words)


@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_crc_gate_names_the_flipped_slice(dev, crc_window, where):
  """One word flipped in a slice's first, middle or last chunk (and a
  later slice flipped too): the gate names the first of them."""
  words, stored = crc_window
  W = words.shape[1]
  G = tcrc.chunk_groups(64, W, _build.sm_count(dev))
  chunk = G * tcrc.GROUP
  assert W // chunk >= 3
  at = {"first": 5, "middle": W // 2 + 77, "last": W - 1}[where]
  bad = words.clone()
  bad[17, at] ^= -2 ** 31 if where == "middle" else 1
  bad[40, 0] ^= 4
  teng.crc_gate(words, stored, 100)
  with pytest.raises(ct.FormatError, match="crc mismatch on z=117 "):
    teng.crc_gate(bad, stored, 100)


def test_crc_gate_waits_once_and_launches_once(dev, crc_window):
  """A clean gate: one launch of the kernel a gate, one wait that torch's
  sync debug mode reports and its span counts, its tables copied to the
  card once."""
  import warnings
  from crackle_tpu_torch.utils import profiling
  words, stored = crc_window
  teng.crc_gate(words, stored, 0)
  torch.cuda.synchronize(dev)
  _build.reset_launches()
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
      with profiling.recording():
        for _ in range(3):
          teng.crc_gate(words, stored, 0)
    finally:
      torch.cuda.set_sync_debug_mode("default")
  waits = [w for w in caught if "called a synchronizing" in str(w.message)]
  assert len(waits) == 3, [str(w.message) for w in waits]
  assert _build.LAUNCHES["crc32c_rows"] == 3
  gates = [s for s in profiling.spans() if s.name == "engine.crc_gate"]
  assert [s.counters for s in gates] == [{"host_syncs": 1}] * 3
