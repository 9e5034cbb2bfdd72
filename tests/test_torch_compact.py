"""The compact-cancel replay (cancel_sums -> compact_closes ->
replay_positions_compact) against the reference's compact path in
interpret mode, and against the port's default replay: exact
everywhere."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import crackle_tpu as crackle
from crackle_tpu.headers import CrackFormat
from crackle_tpu.kernels import ccl_pallas, replay_big, replay_pallas
from crackle_tpu.kernels import engine as jeng
import crackle_tpu_torch as ct
from crackle_tpu_torch.kernels import engine as teng
from crackle_tpu_torch.kernels import replay

from test_jax_decode import random_volume
from test_torch_replay import islands_volume, random_stream, spiral_volume

# the volumes of test_jax_decode.test_replay_big_compact_cancel_path,
# and one with more than 32 chains per slice
VOLUMES = {
  "spiral": spiral_volume,
  "random 33x17x3": lambda: random_volume((33, 17, 3), 6, 34, 6),
  "random 16x16x3": lambda: random_volume((16, 16, 3), 2, 33, 0),
  "islands": islands_volume,
}


def _stream(name):
  binary = crackle.compress(VOLUMES[name]())
  return binary, crackle.header(binary)


def _padded_inputs(binary, head):
  """The reference's padded slice inputs, at least 256 codepoints (the
  chunked replay's smallest CAP)."""
  inputs = jeng.prepare_slice_inputs(binary, 0, head.sz)
  CAP_B = max(inputs["packed"].shape[1], 64)
  packed = np.zeros((head.sz, CAP_B), np.uint8)
  packed[:, :inputs["packed"].shape[1]] = inputs["packed"]
  return dict(inputs, packed=packed)


def _port_stages(inputs):
  t = teng.params_from_jax(inputs, device="cpu")
  return (t,) + replay.replay_keys(t["packed"], t["nbytes"], t["n_chains"])


@pytest.fixture
def compact_reference(monkeypatch):
  """The force_big set-up of test_jax_decode with the compact path."""
  monkeypatch.setattr(ccl_pallas, "INTERPRET", True)
  monkeypatch.setattr(replay_pallas, "FORCE_BIG", True)
  monkeypatch.setattr(replay_big, "CHUNK_R", 2)
  monkeypatch.setattr(replay_big, "CANCEL_COMPACT", True)
  jax.clear_caches()
  yield
  jax.clear_caches()


def _hold_to_reference(inputs, sx, sy, permissible):
  """cancel_sums_plain and compact_closes_plain against the reference's
  compact path (its stash) on padded slice inputs: the dense records at
  the closes, and per slice the set of kept table entries, as many as
  min(closes, table); every other entry of the port's tables is empty
  (pos CAP, sums 0). Returns each slice's close count."""
  B, CAP = inputs["packed"].shape[0], inputs["packed"].shape[1] * 4
  assert replay_big.eligible(CAP, inputs["nodes"].shape[1], sx, sy)
  stash = {}
  replay_big.replay_vcg_i32_big(
    *(jnp.asarray(inputs[k]) for k in ("packed", "nbytes", "nodes",
                                       "n_chains")),
    sx, sy, permissible, stash=stash)
  want = [np.asarray(a).reshape(B, CAP) for a in stash["dense_close"]]

  _, ev, cls, drange = _port_stages(inputs)
  dense = replay.cancel_sums_plain(ev, cls, drange).numpy()
  closes = want[0] >= 0
  np.testing.assert_array_equal(dense[0] >= 0, closes)
  for got, ref in zip(dense, want):  # dest, pos, sumH, sumV
    np.testing.assert_array_equal(got[closes], ref[closes])

  ccap = replay.close_cap(CAP, inputs["nodes"].shape[1])
  assert ccap == replay_big._close_rows(CAP, inputs["nodes"].shape[1]) * 128
  tables = replay.compact_closes_plain(torch.from_numpy(dense), ccap).numpy()
  ref_tables = [np.asarray(a).reshape(B, -1)
                for a in stash["compact_sorted"]]
  for z in range(B):
    got = {tuple(r) for r in tables[:, z].T if r[0] < CAP}
    ref = {tuple(r) for r in np.stack([a[z] for a in ref_tables], 1)
           if r[0] < CAP}
    assert got == ref and len(got) == min(int(closes[z].sum()), ccap)
    empty = tables[0, z] >= CAP
    assert (tables[0, z, empty] == CAP).all()
    assert not tables[1:, z, empty].any()
  return closes.sum(1)


@pytest.mark.parametrize("name", ["spiral", "random 33x17x3",
                                  "random 16x16x3"])
def test_cancel_sums_and_compaction_match_reference(compact_reference,
                                                    name):
  binary, head = _stream(name)
  n = _hold_to_reference(_padded_inputs(binary, head), head.sx, head.sy,
                         head.crack_format == CrackFormat.PERMISSIBLE)
  assert n.any()


def _no_close_slice_inputs():
  """The spiral slice, then a slice of one label: no cracks, no
  closes."""
  vol = spiral_volume()
  vol = np.asfortranarray(np.concatenate(
    [vol, np.full_like(vol, 3)], axis=2))
  binary = crackle.compress(vol)
  return _padded_inputs(binary, crackle.header(binary)), vol.shape[:2]


@pytest.mark.parametrize("case", ["no closes", "past the table"])
def test_compaction_edges_match_reference(compact_reference, case):
  """The compaction's edge slices against the reference's: a slice with
  no close (its table all empty), and a corrupt slice whose 2048 closes
  pass its 1536-entry table (the reference keeps ranks 0-1535 too)."""
  if case == "no closes":
    inputs, (sx, sy) = _no_close_slice_inputs()
    n = _hold_to_reference(inputs, sx, sy, False)
    assert n[0] > 0 and n[1] == 0
  else:
    n = _hold_to_reference(many_closes_inputs(), 40, 30, False)
    assert n.tolist() == [2048] and replay.close_cap(4096, 2) == 1536


@pytest.mark.parametrize("tile", [32, 256, 1024])
@pytest.mark.parametrize("name", list(VOLUMES))
def test_compact_ids_equal_replay_positions(monkeypatch, name, tile):
  monkeypatch.setattr(replay, "TILE", tile)
  binary, head = _stream(name)
  inputs = teng.prepare_slice_inputs(binary, 0, head.sz)
  if name == "islands":
    assert inputs["nodes"].shape[1] > 32
  t, ev, cls, drange = _port_stages(inputs)
  want = replay.replay_positions_plain(ev, cls, drange, t["nodes"],
                                       head.sx, head.sy)
  dense = replay.cancel_sums_plain(ev, cls, drange)
  tables = replay.compact_closes_plain(
    dense, replay.close_cap(ev.shape[1], t["nodes"].shape[1]))
  got = replay.replay_positions_compact_plain(cls, tables, t["nodes"],
                                              head.sx, head.sy)
  assert torch.equal(got, want)
  # the wrappers take the plain versions for CPU tensors
  assert torch.equal(replay.replay_positions_compact(
    cls, replay.compact_closes(replay.cancel_sums(ev, cls, drange),
                               tables.shape[2]),
    t["nodes"], head.sx, head.sy), want)


@pytest.mark.parametrize("name", list(VOLUMES))
def test_compact_path_decodes_volume(monkeypatch, name):
  monkeypatch.setattr(replay, "CANCEL_COMPACT", True)
  vol = VOLUMES[name]()
  stream = ct.upload_stream(crackle.compress(vol), "cpu")
  labels, _, _ = stream.decode_window(0, vol.shape[2], check_crcs=True)
  sx, sy, sz = vol.shape
  np.testing.assert_array_equal(
    labels.numpy().reshape(sz, sy, sx).transpose(2, 1, 0), vol)


def many_closes_inputs():
  """One 4096-codepoint slice of 0xAA bytes (every diff 2: a run of
  DOWN-UP terminate pairs) with a chain count past any stream's, so
  every pair is a valid close: 2048 closes against a table of 1536
  (CAP_CH 2). Only a corrupt stream gets here."""
  packed = np.full((1, 1024), 0xAA, np.uint8)
  return {"packed": packed, "nbytes": np.array([1024], np.int32),
          "nodes": np.array([[0, 5]], np.int32),
          "n_chains": np.array([1 << 20], np.int32)}


def test_compaction_drops_ranks_past_the_table():
  t = teng.params_from_jax(many_closes_inputs(), device="cpu")
  ev, cls, drange = replay.replay_keys(t["packed"], t["nbytes"],
                                       t["n_chains"])
  dense = replay.cancel_sums(ev, cls, drange)
  ccap = replay.close_cap(4096, 2)
  assert ccap == 1536 and int(dense[0].max()) + 1 == 2048
  tables = replay.compact_closes(dense, ccap)
  assert tables.shape == (3, 1, ccap)
  assert bool((tables[0] < 4096).all())
  ids = replay.replay_positions_compact(cls, tables, t["nodes"], 40, 30)
  assert ids.shape == (1, 4096)


def test_compact_wrappers_reject_bad_inputs():
  ev = torch.zeros((2, 24), dtype=torch.int32)
  dr = torch.zeros((2, 2), dtype=torch.int32)
  with pytest.raises(ValueError):
    replay.cancel_sums(ev, ev, dr)  # CAP not a power of two
  ev = torch.zeros((2, 16), dtype=torch.int32)
  with pytest.raises(ValueError):
    replay.cancel_sums(ev.to(torch.int64), ev, dr)
  with pytest.raises(ValueError):
    replay.cancel_sums(ev, ev, dr[:1])
  with pytest.raises(ValueError):
    replay.compact_closes(torch.zeros((3, 2, 16), dtype=torch.int32), 8)
  cls = torch.zeros((2, 16), dtype=torch.int32)
  nodes = torch.zeros((2, 2), dtype=torch.int32)
  with pytest.raises(ValueError):
    replay.replay_positions_compact(
      cls, torch.zeros((3, 1, 8), dtype=torch.int32), nodes, 4, 4)


def record_cases():
  """(ev, cls, drange) of replay_keys on the volumes' streams and on
  seeded random-byte streams (CAP 128 to 4096, depth ranges up to about
  CAP / 3, corrupt ones among them)."""
  for name in VOLUMES:
    binary, head = _stream(name)
    yield name, _port_stages(teng.prepare_slice_inputs(binary, 0,
                                                       head.sz))[1:]
  for seed in range(12):
    t, _, _ = random_stream(seed)
    yield f"seed {seed}", replay.replay_keys(t["packed"], t["nbytes"],
                                             t["n_chains"])


def sorted_order(ev):
  """Per slice, the active events' positions in the order of the sorted
  keys, (depth, position), by numpy's lexsort: [(pos, close)]."""
  out = []
  for e in ev.numpy():
    p = np.flatnonzero(e & 1)
    order = np.lexsort((p, e[p] >> 2))
    out.append((p[order], (e[p[order]] >> 1) & 1))
  return out


def check_order(dense, ev, cls):
  """dest and pos of the dense records give exactly the order of the
  sorted keys, and that of numpy's lexsort of (depth, position); returns
  the close count."""
  B, CAP = ev.shape
  dest, pos = dense[0].to(torch.int64), dense[1].to(torch.int64)
  skeys = replay.sorted_keys(ev, cls)
  close = (((skeys >> 2) & 1) > 0) & (skeys != replay.INF)
  assert torch.equal(pos, (skeys >> 3) & (CAP - 1))
  assert torch.equal(dest, torch.where(close, torch.cumsum(close, 1) - 1,
                                       -1))
  for b, (p, c) in enumerate(sorted_order(ev)):
    n = len(p)
    np.testing.assert_array_equal(pos[b, :n].numpy(), p)
    assert (pos[b, n:] == CAP - 1).all() and (dest[b, n:] == -1).all()
    np.testing.assert_array_equal(dest[b, :n].numpy(),
                                  np.where(c > 0, np.cumsum(c) - 1, -1))
  return int(close.sum())


def check_sums(dense, ev, cls, drange):
  """Each close's sums equal the forward walk's cancels at its position
  (_close_cancels), and every other slot's sums are 0."""
  CAP = ev.shape[1]
  dest, pos, sh, sv = dense.to(torch.int64)
  close = dest >= 0
  cancel = replay._close_cancels(ev, cls, drange)
  for plane, off in ((sh, 0), (sv, CAP)):
    at = torch.where(close, off + pos, 2 * CAP)
    assert torch.equal(plane, torch.where(close, torch.gather(cancel, 1, at),
                                          0))


# The depth table is the kernel's (the cuda tests run it at these sizes
# against the plain version); the CPU wrapper must not depend on it.
@pytest.mark.parametrize("table", [1, 8])
@pytest.mark.parametrize("tile", [32, 256])
def test_cancel_sums_order_is_sorted_keys(monkeypatch, tile, table):
  monkeypatch.setattr(replay, "TILE", tile)
  monkeypatch.setattr(replay, "DEPTH_TABLE", table)
  closes = sum(check_order(replay.cancel_sums(ev, cls, dr), ev, cls)
               for _, (ev, cls, dr) in record_cases())
  assert closes > 1000


@pytest.mark.parametrize("table", [1, 8])
@pytest.mark.parametrize("tile", [32, 256])
def test_cancel_sums_at_closes_equal_walk(monkeypatch, tile, table):
  monkeypatch.setattr(replay, "TILE", tile)
  monkeypatch.setattr(replay, "DEPTH_TABLE", table)
  for _, (ev, cls, dr) in record_cases():
    check_sums(replay.cancel_sums(ev, cls, dr), ev, cls, dr)
