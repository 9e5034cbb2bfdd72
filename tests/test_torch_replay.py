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
  tiled classification and the reverse next-close scan crosses seams,
  at 256 codepoints (2 rows of 128) and at the 32 minimum."""
  binary = crackle.compress(spiral_volume())
  inputs, head, permissible = _inputs(binary)
  assert inputs["nbytes"][0] * 4 > 3 * 256
  want = xla_vcg(inputs, head, permissible)
  t = teng.params_from_jax(inputs, device="cpu")
  keys_full, cls_full = replay.replay_keys(t["packed"], t["nbytes"],
                                           t["n_chains"])
  monkeypatch.setattr(replay, "TILE", tile)
  keys, cls = replay.replay_keys(t["packed"], t["nbytes"], t["n_chains"])
  assert torch.equal(keys, keys_full) and torch.equal(cls, cls_full)
  np.testing.assert_array_equal(port_vcg(inputs, head, permissible), want)


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
  keys = torch.zeros((2, 16), dtype=torch.int64)
  cls = torch.zeros((2, 16), dtype=torch.int32)
  with pytest.raises(ValueError):
    replay.replay_positions(keys, cls[:, :8], torch.zeros((2, 2),
                                                          dtype=torch.int32),
                            4, 4)
  with pytest.raises(ValueError):
    replay.paint_vcg(cls.to(torch.int64), 4, 4, True)
