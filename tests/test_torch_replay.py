"""The port's replay (plain versions of the replay kernels on the CPU)
gives the VCG of the JAX replay, bit for bit."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import crackle_tpu as crackle
from crackle_tpu.headers import CrackFormat
from crackle_tpu.kernels import ccl_pallas, replay_big, replay_pallas
from crackle_tpu.kernels import decode as jdec
from crackle_tpu_torch.kernels import decode as tdec
from crackle_tpu_torch.kernels import engine as teng
from crackle_tpu_torch.kernels import replay

from test_jax_decode import CASES, blocky_volume, random_volume

# the XLA replay, compiled once per shape (it reads no dispatch flag)
_xla_replay = jax.jit(jdec._decode_vcg_batch, static_argnums=(4, 5, 6))


def spiral_volume():
  """One long branch-poor boundary: sorted depth segments span
  thousands of events, so moves and their closes lie many tiles
  apart."""
  vol = np.zeros((65, 65, 1), dtype=np.uint32)
  x0 = y0 = 0
  x1 = y1 = 64
  while x1 > x0:
    vol[x0:x1 + 1, y0, 0] = 1
    vol[x1, y0:y1 + 1, 0] = 1
    vol[x0:x1 + 1, y1, 0] = 1
    if y0 + 2 <= y1:
      vol[x0, y0 + 2:y1 + 1, 0] = 1
    x0 += 2
    y0 += 2
    x1 -= 2
    y1 -= 2
  return np.asfortranarray(vol)


def islands_volume():
  """Isolated 3x3 islands: one chain each, 56 chains per slice."""
  vol = np.ones((48, 40, 2), np.uint32)
  k = 2
  for x0 in range(1, 45, 6):
    for y0 in range(1, 37, 6):
      vol[x0:x0 + 3, y0:y0 + 3, :] = k
      k += 1
  return np.asfortranarray(vol)


def _inputs(binary):
  inputs = teng.prepare_slice_inputs(binary, 0, crackle.header(binary).sz)
  head = inputs["head"]
  return inputs, head, head.crack_format == CrackFormat.PERMISSIBLE


def port_vcg(inputs, head, permissible):
  t = teng.params_from_jax(inputs, device="cpu")
  vcg = tdec._vcg_for_ccl(t["packed"], t["nbytes"], t["nodes"],
                          t["n_chains"], head.sx, head.sy, permissible)
  assert vcg.dtype == torch.int32
  assert vcg.shape == (len(inputs["nbytes"]), head.sy, head.sx)
  return vcg.numpy().reshape(vcg.shape[0], -1)


def jax_args(inputs):
  return tuple(jnp.asarray(inputs[k])
               for k in ("packed", "nbytes", "nodes", "n_chains"))


def xla_vcg(inputs, head, permissible):
  return np.asarray(_xla_replay(
    *jax_args(inputs), head.sx, head.sy, permissible)).astype(np.int32)


def check_against_xla(binary):
  inputs, head, permissible = _inputs(binary)
  np.testing.assert_array_equal(port_vcg(inputs, head, permissible),
                                xla_vcg(inputs, head, permissible))
  return inputs


@pytest.mark.parametrize("shape,nl,seed,smooth", CASES)
def test_replay_matches_xla(shape, nl, seed, smooth):
  check_against_xla(crackle.compress(random_volume(shape, nl, seed, smooth)))


@pytest.mark.parametrize("vol,fmt", [
  (random_volume((16, 16, 4), 2, 2, 0), CrackFormat.PERMISSIBLE),
  (blocky_volume((20, 18, 3), 4, 5, 31), CrackFormat.IMPERMISSIBLE),
], ids=["permissible", "impermissible"])
def test_replay_both_crack_formats(vol, fmt):
  binary = crackle.compress(vol)
  assert crackle.header(binary).crack_format == fmt
  check_against_xla(binary)


@pytest.mark.parametrize("order", [1, 5])
def test_replay_markov_stream(order):
  binary = crackle.compress(random_volume((24, 20, 3), 6, 21 + order, 5),
                            markov_model_order=order)
  assert crackle.header(binary).markov_model_order == order
  check_against_xla(binary)


@pytest.mark.parametrize("shape,nl,seed,smooth", [
  ((513, 6, 2), 5, 41, 3),
  ((600, 9, 2), 7, 42, 4),
])
def test_replay_wide_slices(shape, nl, seed, smooth):
  """sx >= 512: the TPU needed a second, segmented paint raster here."""
  check_against_xla(crackle.compress(random_volume(shape, nl, seed, smooth)))


def test_replay_many_chains():
  """More than 32 chains per slice takes the XLA replay's other
  chain-base branch (decode.py:232)."""
  inputs = check_against_xla(crackle.compress(islands_volume()))
  assert inputs["nodes"].shape[1] > 32


@pytest.mark.parametrize("tile", [32, 256])
def test_replay_tile_seams(monkeypatch, tile):
  """Moves whose scope closes lie many tiles later: every carry of the
  tiled classification and the forward walk's per-depth pending sums
  cross seams, at 256 codepoints (2 rows of 128) and at the 32
  minimum."""
  binary = crackle.compress(spiral_volume())
  inputs, head, permissible = _inputs(binary)
  assert inputs["nbytes"][0] * 4 > 3 * 256
  want = xla_vcg(inputs, head, permissible)
  t = teng.params_from_jax(inputs, device="cpu")
  full = replay.replay_keys(t["packed"], t["nbytes"], t["n_chains"])
  ids_full = replay.replay_positions(*full, t["nodes"], head.sx, head.sy)
  monkeypatch.setattr(replay, "TILE", tile)
  got = replay.replay_keys(t["packed"], t["nbytes"], t["n_chains"])
  for a, b in zip(got, full):  # event words, cls, depth range
    assert torch.equal(a, b)
  ids = replay.replay_positions(*got, t["nodes"], head.sx, head.sy)
  assert torch.equal(ids, ids_full)
  assert torch.equal(ids, oracle_positions(*got, t["nodes"], head.sx,
                                           head.sy))
  np.testing.assert_array_equal(port_vcg(inputs, head, permissible), want)


# ---------------------------------------------------------------------------
# the sort-based replay the port used before its forward walk, kept as
# the oracle of the walk: sorted (depth, position) keys, a reverse scan
# for each move's next close at its depth, a scatter of the +-1s
# ---------------------------------------------------------------------------

def _next_close(skeys, CAP):
  """Per sorted event, the position of the next close at the same
  depth (CAP if none), by a reverse scan."""
  B = skeys.shape[0]
  logcap = CAP.bit_length() - 1
  inf = skeys == replay.INF
  close = (((skeys >> 2) & 1) > 0) & ~inf
  body = skeys >> 3
  depth = body >> logcap
  nxt_inf = torch.cat([inf[:, 1:], torch.ones((B, 1), dtype=torch.bool)], 1)
  nxt_depth = torch.cat([depth[:, 1:], depth[:, -1:]], 1)
  seg_last = inf | nxt_inf | (depth != nxt_depth)
  e = torch.where(close | seg_last,
                  torch.where(close, body & (CAP - 1), CAP), -1)
  # index of the nearest set entry at or after each element
  n = CAP
  k = torch.where(e >= 0, torch.arange(n)[None, :], n)
  k = torch.flip(torch.cummin(torch.flip(k, [1]), 1).values, [1])
  got = torch.gather(e, 1, torch.clamp(k, max=n - 1))
  nc = torch.where(k < n, got, -1)
  return torch.where(nc < 0, CAP, nc)


def oracle_positions(ev, cls, drange, nodes, sx, sy):
  """Edge ids by the sort-based replay (the reference's decode.py:
  168-208) from replay_keys' outputs."""
  skeys = replay.sorted_keys(ev, cls)
  B, CAP = skeys.shape
  inf = skeys == replay.INF
  cps_s = skeys & 3
  close = (((skeys >> 2) & 1) > 0) & ~inf
  nc = _next_close(skeys, CAP)
  ok = ~inf & ~close & (nc < CAP)
  isV = (cps_s == replay.UP) | (cps_s == replay.DOWN)
  w = torch.where((cps_s == replay.LEFT) | (cps_s == replay.UP), 1, -1)
  bins = torch.where(ok, isV.to(torch.int64) * CAP + nc, 2 * CAP)
  cancel = torch.zeros((B, 2 * CAP + 1), dtype=torch.int64)
  cancel.scatter_add_(1, bins, torch.where(ok, w, 0))
  return replay._replay_forward_plain(cancel, cls, nodes, sx, sy)


def _pack(diffs):
  """(B, CAP) 2-bit diffs -> (B, CAP / 4) packed uint8."""
  d = diffs.reshape(diffs.shape[0], -1, 4).astype(np.uint8)
  return d[..., 0] | (d[..., 1] << 2) | (d[..., 2] << 4) | (d[..., 3] << 6)


def random_stream(seed, B=3, CAP=None):
  """Seeded random-byte replay inputs (corrupt or not, the replay must
  give the oracle's ids): B slices of CAP codepoints (by default 3 of
  128 to 4096); per slice uniform bytes, or runs of [1, 1, 2] diffs (a
  move, a move, a reversal) whose phase makes every pair a branch, so
  depths climb towards CAP / 3, or a terminate, with a share of uniform
  noise; random nbytes (full on some slices), n_chains (0 on some) and
  chain start nodes."""
  rng = np.random.RandomState(seed)
  CAP = CAP or 128 << (seed % 6)
  sx, sy = rng.randint(1, 40, 2)
  diffs = rng.randint(0, 4, (B, CAP))
  for b in range(B):
    mode = (seed + b) % 3
    if mode:
      run = np.tile([1, 1, 2], CAP // 3 + 1)[:CAP - 1]
      diffs[b] = np.concatenate([[1 if mode == 1 else 0], run])
      noise = rng.rand(CAP) < rng.choice([0.0, 0.01, 0.2])
      diffs[b, noise] = rng.randint(0, 4, int(noise.sum()))
  nbytes = rng.randint(0, CAP // 4 + 1, B)
  nbytes[seed % B] = CAP // 4
  n_chains = rng.randint(0, 9, B)
  n_chains[(seed + 1) % B] = 0 if seed % 2 else rng.randint(1 << 10)
  CAP_CH = rng.randint(1, 9)
  nodes = rng.randint(0, (sx + 1) * (sy + 1), (B, CAP_CH))
  inputs = {"packed": _pack(diffs), "nbytes": nbytes.astype(np.int32),
            "nodes": nodes.astype(np.int32),
            "n_chains": n_chains.astype(np.int32)}
  return teng.params_from_jax(inputs, device="cpu"), int(sx), int(sy)


@pytest.mark.parametrize("seed", range(50))
def test_walk_matches_sort_oracle(seed):
  """The forward walk's ids equal the sort-based oracle's on random
  bytes, at the default tile and at the smallest."""
  t, sx, sy = random_stream(seed)
  ev, cls, drange = replay.replay_keys(t["packed"], t["nbytes"],
                                       t["n_chains"])
  # the depth range is each slice's measured one
  _, _, _, depth, _, _ = replay._unpack_events(ev, cls)
  act = (ev & 1) > 0
  for b in range(ev.shape[0]):
    d = depth[b][act[b]]
    want = [int(d.min()), int(d.max())] if len(d) else [0, -1]
    assert drange[b].tolist() == want
  want = oracle_positions(ev, cls, drange, t["nodes"], sx, sy)
  assert torch.equal(replay.replay_positions(ev, cls, drange, t["nodes"],
                                             sx, sy), want)
  replay.TILE, default = 32, replay.TILE
  try:
    got = replay.replay_keys(t["packed"], t["nbytes"], t["n_chains"])
    for a, b in zip(got, (ev, cls, drange)):
      assert torch.equal(a, b)
    assert torch.equal(replay.replay_positions_plain(
      ev, cls, drange, t["nodes"], sx, sy), want)
  finally:
    replay.TILE = default


def test_random_streams_reach_deep_ranges():
  """The random streams cover empty slices, n_chains = 0 and depth
  ranges up to about CAP / 3 (the branch runs)."""
  widest, chains0 = 0.0, False
  for seed in range(50):
    t, _, _ = random_stream(seed)
    _, _, drange = replay.replay_keys(t["packed"], t["nbytes"],
                                      t["n_chains"])
    CAP = t["packed"].shape[1] * 4
    R = (drange[:, 1] - drange[:, 0] + 1).max().item()
    widest = max(widest, R / CAP)
    chains0 |= bool((t["n_chains"] == 0).any())
  assert widest > 0.3 and chains0


@pytest.mark.parametrize("sx,sy,bands", [(40, 30, 2), (40, 30, 5),
                                         (7, 64, 3), (300, 2, 4)])
def test_paint_bands_match_unbanded(monkeypatch, sx, sy, bands):
  """paint_vcg_plain with PAINT_SMEM_MAX shrunk so that it walks 2-5
  bands of pixels (seams inside rows and across them) equals the
  unbanded paint, on every edge id of the slice, none, and random
  ones with ids out of range."""
  NB = sy * (sx + 1) + (sy + 1) * sx
  rng = np.random.RandomState(sx + bands)
  ids = np.stack([np.arange(NB), np.full(NB, -1),
                  rng.randint(-5, NB + 5, NB)]).astype(np.int32)
  ids = torch.from_numpy(ids)
  want = [replay.paint_vcg(ids, sx, sy, p) for p in (True, False)]
  smem = 4 * replay._band_words(32 * -(-sx * sy // (32 * bands)), sx)
  monkeypatch.setattr(replay, "PAINT_SMEM_MAX", smem)
  P = replay.paint_band_px(sx, sy)
  assert 2 <= -(-sx * sy // P) <= 5
  for p, w in zip((True, False), want):
    assert torch.equal(replay.paint_vcg(ids, sx, sy, p), w)


def test_replay_matches_pallas_interpret(monkeypatch):
  """Against the fused Pallas replay (replay_pallas) in interpret mode."""
  monkeypatch.setattr(ccl_pallas, "INTERPRET", True)
  binary = crackle.compress(random_volume((64, 48, 2), 14, 123, 6))
  inputs, head, permissible = _inputs(binary)
  CAP = inputs["packed"].shape[1] * 4
  assert replay_pallas.eligible(CAP, inputs["nodes"].shape[1], head.sx,
                                head.sy)
  want = np.asarray(replay_pallas.replay_vcg_traced(
    *jax_args(inputs), head.sx, head.sy, permissible)).astype(np.int32)
  np.testing.assert_array_equal(port_vcg(inputs, head, permissible), want)


def test_replay_matches_big_chunked_interpret(monkeypatch):
  """Against the chunked Pallas replay (replay_big) with 2-row chunks,
  the force_big setup of test_jax_decode, in interpret mode."""
  monkeypatch.setattr(ccl_pallas, "INTERPRET", True)
  monkeypatch.setattr(replay_pallas, "FORCE_BIG", True)
  monkeypatch.setattr(replay_big, "CHUNK_R", 2)
  jax.clear_caches()
  try:
    binary = crackle.compress(random_volume((16, 16, 3), 5, 32, 4))
    inputs, head, permissible = _inputs(binary)
    want = np.asarray(replay_big.replay_vcg_i32_big(
      *jax_args(inputs), head.sx, head.sy, permissible))
  finally:
    jax.clear_caches()
  np.testing.assert_array_equal(
    port_vcg(inputs, head, permissible), want.reshape(want.shape[0], -1))


def test_replay_empty_slice_is_constant():
  """nbytes = 0: no moves, so the VCG of a constant slice."""
  packed = torch.zeros((2, 4), dtype=torch.uint8)
  zero = torch.zeros(2, dtype=torch.int32)
  nodes = torch.zeros((2, 2), dtype=torch.int32)
  for permissible, want in [(True, 0), (False, 0b1111)]:
    vcg = tdec._vcg_for_ccl(packed, zero, nodes, zero, 5, 3, permissible)
    assert vcg.shape == (2, 3, 5)
    assert bool((vcg == want).all())


def test_replay_wrappers_reject_bad_inputs():
  packed = torch.zeros((2, 4), dtype=torch.uint8)
  n = torch.zeros(2, dtype=torch.int32)
  with pytest.raises(ValueError):
    replay.replay_keys(packed.to(torch.int32), n, n)
  with pytest.raises(ValueError):
    replay.replay_keys(packed, n[:1], n)
  ev = torch.zeros((2, 16), dtype=torch.int32)
  cls = torch.zeros((2, 16), dtype=torch.int32)
  drange = torch.zeros((2, 2), dtype=torch.int32)
  nodes = torch.zeros((2, 2), dtype=torch.int32)
  with pytest.raises(ValueError):
    replay.replay_positions(ev, cls[:, :8], drange, nodes, 4, 4)
  with pytest.raises(ValueError):
    replay.replay_positions(ev.to(torch.int64), cls, drange, nodes, 4, 4)
  with pytest.raises(ValueError):
    replay.replay_positions(ev, cls, drange[:1], nodes, 4, 4)
  with pytest.raises(ValueError):
    replay.paint_vcg(cls.to(torch.int64), 4, 4, True)
