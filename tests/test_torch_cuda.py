"""The CUDA kernels against their plain versions, on the card.

These need a CUDA device and skip without one:

  python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import crackle_tpu as crackle
from crackle_tpu.headers import CrackFormat
from crackle_tpu_torch.kernels import ccl, replay
from crackle_tpu_torch.kernels import engine as teng

from test_jax_decode import CASES, random_volume
from test_torch_replay import islands_volume, spiral_volume

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  return torch.device("cuda")


def _volumes():
  vols = [random_volume(*c) for c in CASES]
  vols += [random_volume((600, 9, 2), 7, 42, 4), spiral_volume(),
           islands_volume()]
  return vols


def _stages(t, head, cpu):
  """keys, cls, sorted keys, ids, vcg, (cc, N) of one batch, with the
  kernels (cpu=False) or the plain versions on the CPU."""
  if cpu:
    t = {k: v.cpu() for k, v in t.items()}
  perm = head.crack_format == CrackFormat.PERMISSIBLE
  keys, cls = replay.replay_keys(t["packed"], t["nbytes"], t["n_chains"])
  skeys = torch.sort(keys, 1).values
  ids = replay.replay_positions(skeys, cls, t["nodes"], head.sx, head.sy)
  vcg = replay.paint_vcg(ids, head.sx, head.sy, perm)
  cc, N, _ = ccl.ccl_paint(vcg)
  return [x.cpu() for x in (keys, cls, torch.sort(ids, 1).values, vcg, cc,
                            N)]


@pytest.mark.parametrize("tile", [32, 1024])
def test_kernels_match_plain(dev, monkeypatch, tile):
  monkeypatch.setattr(replay, "TILE", tile)
  for vol in _volumes():
    binary = crackle.compress(vol)
    inputs = teng.prepare_slice_inputs(binary, 0, vol.shape[2])
    t = teng.params_from_jax(inputs, device=dev)
    for got, want in zip(_stages(t, inputs["head"], False),
                         _stages(t, inputs["head"], True)):
      assert torch.equal(got, want)


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


def test_paint_k2_matches_plain(dev):
  rng = np.random.RandomState(2)
  vcg = torch.from_numpy(
    (rng.randint(0, 16, size=(3, 37, 29)) & 0b1010).astype(np.int32))
  T = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, size=(3, 2, 256),
                                   dtype=np.int64).astype(np.int32))
  got = ccl.ccl_paint(vcg.to(dev), T.to(dev))
  want = ccl.ccl_paint(vcg, T)
  for g, w in zip(got, want):
    assert torch.equal(g.cpu(), w)
