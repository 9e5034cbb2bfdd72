"""The port's z-sharded codec (crackle_tpu_torch/parallel/sharding.py)
on CPU meshes of 1, 3 and 8 shards, against crackle_tpu.parallel on the
virtual 8-device CPU mesh of tests/conftest.py: volumes, CCL images,
counts and stream bytes equal."""
import functools
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crackle_tpu as crackle
from crackle_tpu import parallel as rpar
import crackle_tpu_torch.parallel as tpar
from crackle_tpu_torch.kernels import engine as teng
from crackle_tpu_torch.parallel import sharding as tsh

from test_sharding import random_volume

SHARDS = [1, 3, 8]

# name -> (shape, labels, seed, smoothing passes, dtype, label offset,
# compress keywords): tests/test_sharding.py's decode volumes, the cases
# of its test_decompress_sharded_formats (whose allow_pins volume comes
# out flat) and two volumes that come out as condensed pins
STREAMS = {
  "16^3": ((16, 16, 16), 5, 0, 4, np.uint32, 0, {}),
  "unaligned 12x12x11": ((12, 12, 11), 4, 1, 3, np.uint32, 0, {}),
  "allow_pins, flat": ((18, 14, 8), 5, 7, 5, np.uint32, 0,
                       {"allow_pins": 1}),
  "pins 20x16x9": ((20, 16, 9), 3, 3, 8, np.uint32, 0, {"allow_pins": 1}),
  "pins 18x14x11": ((18, 14, 11), 3, 4, 10, np.uint32, 0, {"allow_pins": 1}),
  "markov-5": ((18, 14, 8), 5, 7, 5, np.uint32, 0,
               {"markov_model_order": 5}),
  "u64 + 2^40": ((18, 14, 8), 5, 7, 5, np.uint64, 2 ** 40, {}),
  "sz 11": ((18, 14, 11), 5, 7, 5, np.uint32, 0, {}),
}

# tests/test_sharding.py:test_compress_sharded_byte_identity's cases
ENCODES = [((24, 24, 16), 8, 61, 4, np.uint32),
           ((20, 18, 11), 6, 62, 3, np.uint32),
           ((16, 16, 3), 2, 63, 0, np.uint32),
           ((16, 16, 8), 5, 64, 4, np.uint64)]


def mesh(n):
  return tpar.make_mesh(["cpu"] * n)


@functools.lru_cache(maxsize=None)
def stream(name):
  """(volume, crackle_tpu.compress bytes) of a STREAMS entry."""
  shape, nl, seed, smooth, dtype, off, kw = STREAMS[name]
  vol = random_volume(shape, nl, seed, smooth, dtype=dtype)
  if off:
    vol = np.asfortranarray(vol + dtype(off))
  binary = crackle.compress(vol, **kw)
  assert (crackle.header(binary).label_format == 2) == name.startswith(
    "pins")
  return vol, binary


@functools.lru_cache(maxsize=None)
def ref_decompress(name):
  return rpar.decompress_sharded(stream(name)[1], rpar.make_mesh())


def encode_volume(case):
  shape, nl, seed, smooth, dtype = case
  vol = random_volume(shape, nl, seed, smooth, dtype=dtype)
  return vol + np.uint64(2) ** 40 if dtype == np.uint64 else vol


@functools.lru_cache(maxsize=None)
def ref_compress(i):
  vol = encode_volume(ENCODES[i])
  return crackle.compress(vol), rpar.compress_sharded(vol, rpar.make_mesh())


def as_tensor(vol):
  """An unsigned numpy volume as a CPU tensor of the same dtype and
  strides."""
  signed = {4: np.int32, 8: np.int64}[vol.dtype.itemsize]
  unsigned = {4: torch.uint32, 8: torch.uint64}[vol.dtype.itemsize]
  return torch.from_numpy(vol.view(signed)).view(unsigned)


def flat_keys(binary):
  """(dictionary, each slice's first component, component -> dictionary
  keys) of a flat stream, as tests/test_sharding.py builds them."""
  return teng._flat_label_tables(crackle.header(binary), binary)


def test_make_mesh_raises_without_cuda(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    tpar.make_mesh()
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    tpar.make_mesh(["cuda:0"])
  m = tpar.make_mesh(["cpu", torch.device("cpu")], group=None)
  assert m.devices == (torch.device("cpu"),) * 2 and m.axis_name == "z"


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("name", list(STREAMS))
def test_decompress_sharded_matches_reference(n, name):
  vol, binary = stream(name)
  want = ref_decompress(name)
  got = tpar.decompress_sharded(binary, mesh(n))
  assert got.dtype == want.dtype and got.shape == want.shape
  assert got.flags.f_contiguous == want.flags.f_contiguous
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, vol)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("name,z0,z1", [("16^3", 0, 16), ("16^3", 3, 14),
                                        ("unaligned 12x12x11", 0, 11),
                                        ("markov-5", 1, 8)])
def test_decode_window_ccl_sharded_matches_reference(n, name, z0, z1):
  binary = stream(name)[1]
  cc, N, head = tpar.decode_window_ccl_sharded(binary, z0, z1, mesh(n))
  rcc, rN, rhead = rpar.decode_window_ccl_sharded(binary, z0, z1,
                                                  rpar.make_mesh())
  assert (head.sx, head.sy, head.sz) == (rhead.sx, rhead.sy, rhead.sz)
  assert cc.dtype == np.int32 and N.dtype == np.int32
  np.testing.assert_array_equal(cc, rcc)
  np.testing.assert_array_equal(N, rN)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("shape,nl,seed,smooth", [
  ((12, 12, 8), 5, 2, 2), ((16, 16, 16), 5, 0, 4), ((12, 12, 11), 4, 1, 3)])
def test_voxel_counts_sharded_matches_reference(n, shape, nl, seed, smooth):
  vol = random_volume(shape, nl, seed, smooth)
  binary = crackle.compress(vol)
  got = tpar.voxel_counts_sharded(binary, mesh(n))
  assert got == rpar.voxel_counts_sharded(binary, rpar.make_mesh())
  uniq, counts = np.unique(vol, return_counts=True)
  assert got == dict(zip(uniq.tolist(), counts.tolist()))


@functools.lru_cache(maxsize=None)
def roundtrip_case():
  """tests/test_sharding.py:test_sharded_roundtrip_step_runs' volume, its
  stream, the port's prepared inputs, keys and offsets, and the
  reference's step outputs on the 8-device mesh."""
  vol = random_volume((8, 8, 8), 3, seed=3, smooth=3)
  binary = crackle.compress(vol)
  head = crackle.header(binary)
  inputs = teng.prepare_slice_inputs(binary, 0, 8)
  _, cum, keys = flat_keys(binary)
  offs = cum[:8].astype(np.int32)
  step = rpar.sharded_roundtrip_step(rpar.make_mesh(), 8, 8,
                                     permissible=head.crack_format == 1)
  ref = step(*[jnp.asarray(inputs[k]) for k in ("packed", "nbytes", "nodes",
                                                "n_chains")],
             jnp.asarray(keys.astype(np.int32)), jnp.asarray(offs))
  return vol, binary, head, inputs, keys, offs, [np.asarray(r) for r in ref]


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("as_tensors", [False, True])
def test_sharded_roundtrip_step_matches_reference(n, as_tensors):
  vol, binary, head, inputs, keys, offs, (rcc, rcounts, rz) = \
    roundtrip_case()
  step = tpar.sharded_roundtrip_step(mesh(n), 8, 8,
                                     permissible=head.crack_format == 1)
  args = [inputs[k] for k in ("packed", "nbytes", "nodes", "n_chains")] + [
    keys, offs]
  if as_tensors:
    args = [torch.from_numpy(np.asarray(a).astype(np.int64)) for a in args]
  cc, counts, z_index = step(*args)
  assert cc.dtype == torch.int32 and counts.dtype == torch.int64
  np.testing.assert_array_equal(cc.numpy(), rcc)
  np.testing.assert_array_equal(counts.numpy(), rcounts)
  np.testing.assert_array_equal(z_index.numpy(), rz)
  np.testing.assert_array_equal(z_index.numpy(), inputs["nbytes"])
  uniq, want = np.unique(vol, return_counts=True)
  lbls = crackle.labels(binary)
  for u, c in zip(uniq.tolist(), want.tolist()):
    assert counts[int(np.searchsorted(lbls, u))] == c


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("i", range(len(ENCODES)))
@pytest.mark.parametrize("as_tensors", [False, True])
def test_compress_sharded_matches_reference(n, i, as_tensors):
  vol = encode_volume(ENCODES[i])
  want, ref_sharded = ref_compress(i)
  assert ref_sharded == want
  got = tsh.compress_sharded(as_tensor(vol) if as_tensors else vol, mesh(n))
  assert got == want


@pytest.mark.parametrize("labels,reason", [
  (np.zeros((4, 4), np.uint32), "ndim=2"),
  (np.zeros((4, 4, 2), np.int32), "signed dtype"),
  (np.zeros((1, 4, 2), np.uint32), "degenerate shape"),
  (np.zeros((4, 4, 0), np.uint32), "degenerate shape"),
])
def test_compress_sharded_declines_as_reference(caplog, labels, reason):
  assert rpar.compress_sharded(labels, rpar.make_mesh()) is None
  with caplog.at_level(logging.WARNING, logger="crackle_tpu_torch.engine"):
    assert tsh.compress_sharded(labels, mesh(3)) is None
    assert tsh.compress_sharded(torch.from_numpy(labels), mesh(3)) is None
  assert reason in caplog.text


def test_sharded_decode_declines_wide_pins_as_reference(caplog):
  vol = random_volume((12, 10, 6), 3, 5, 4, dtype=np.uint64) \
    + np.uint64(2) ** 40
  binary = crackle.compress(vol, allow_pins=1)
  assert crackle.header(binary).label_format == 2
  assert rpar.decompress_sharded(binary, rpar.make_mesh()) is None
  with caplog.at_level(logging.WARNING, logger="crackle_tpu_torch.engine"):
    assert tpar.decompress_sharded(binary, mesh(3)) is None
  assert "pins table extraction declined" in caplog.text


def test_dryrun_multichip_cases_at_8():
  """The cases of __graft_entry__.dryrun_multichip(8) on an 8-shard CPU
  mesh: the roundtrip step's counts and z index, the full decode of a
  flat, pins, markov, u64 and unaligned-z stream, and the encode at u32
  and u64, against the volumes and crackle_tpu's bytes."""
  m = mesh(8)
  sx = sy = 16
  sz = 16
  rng = np.random.RandomState(0)
  vol = rng.randint(0, 3, size=(sx, sy, sz)).astype(np.uint32)
  for _ in range(6):
    axis = rng.randint(0, 3)
    mask = rng.rand(sx, sy, sz) < 0.6
    vol = np.where(mask, np.roll(vol, 1, axis=axis), vol)
  vol = np.asfortranarray(vol)
  binary = crackle.compress(vol)
  head = crackle.header(binary)

  inputs = teng.prepare_slice_inputs(binary, 0, sz)
  uniq, cum, keys = flat_keys(binary)
  step = tpar.sharded_roundtrip_step(m, sx, sy,
                                     permissible=head.crack_format == 1)
  cc, counts, z_index = step(inputs["packed"], inputs["nbytes"],
                             inputs["nodes"], inputs["n_chains"], keys,
                             cum[:sz])
  u, want = np.unique(vol, return_counts=True)
  for label, c in zip(u.tolist(), want.tolist()):
    assert int(counts[int(np.searchsorted(uniq, label))]) == c
  np.testing.assert_array_equal(z_index.numpy(), inputs["nbytes"])
  np.testing.assert_array_equal(tpar.decompress_sharded(binary, m), vol)

  def mkvol(dtype, sz2, hi=3, seed=1):
    rng2 = np.random.RandomState(seed)
    v = rng2.randint(0, hi, size=(sx, sy, sz2)).astype(dtype)
    for _ in range(6):
      ax = rng2.randint(0, 3)
      mask = rng2.rand(sx, sy, sz2) < 0.6
      v = np.where(mask, np.roll(v, 1, axis=ax), v)
    return np.asfortranarray(v)

  for name, b2 in [
      ("pins", crackle.compress(mkvol(np.uint32, sz), allow_pins=1)),
      ("markov", crackle.compress(mkvol(np.uint32, sz),
                                  markov_model_order=5)),
      ("u64", crackle.compress(mkvol(np.uint64, sz) + np.uint64(2) ** 40)),
      ("unaligned-z", crackle.compress(mkvol(np.uint32, sz + 1)))]:
    out = tpar.decompress_sharded(b2, m)
    assert out is not None, name
    np.testing.assert_array_equal(out, crackle.decompress(b2), name)

  assert tpar.compress_sharded(vol, m) == binary
  vol64 = mkvol(np.uint64, sz) + np.uint64(2) ** 40
  assert tpar.compress_sharded(vol64, m) == crackle.compress(vol64)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("name", ["islands", "nuclei"])
def test_sharded_decode_of_long_slices(monkeypatch, n, name):
  """Slices past MAX_DEVICE_CAP (shrunk to 1024 codepoints in both
  packages): the sharded entry points take them whole, as the
  reference's do, and equal the reference, the volume and the unsharded
  split decode."""
  from crackle_tpu.kernels import engine as jeng
  from test_torch_window import islands, nuclei_volume
  monkeypatch.setattr(jeng, "MAX_DEVICE_CAP", 1024)
  monkeypatch.setattr(teng, "MAX_DEVICE_CAP", 1024)
  vol = islands(4, 96) if name == "islands" else nuclei_volume(120, 96, 5)
  binary = crackle.compress(vol)
  sz = vol.shape[2]
  assert not teng._device_cap_ok(teng.prepare_slice_inputs(binary, 0, sz))
  got = tpar.decompress_sharded(binary, mesh(n))
  np.testing.assert_array_equal(got, vol)
  np.testing.assert_array_equal(
    got, rpar.decompress_sharded(binary, rpar.make_mesh()))
  np.testing.assert_array_equal(got, teng.decode_window(binary, 0, sz,
                                                        device="cpu"))
  cc, N, _ = tpar.decode_window_ccl_sharded(binary, 0, sz, mesh(n))
  want_cc, want_N, _ = teng.decode_window_ccl_device(binary, 0, sz, "cpu")
  np.testing.assert_array_equal(cc, want_cc.numpy())
  np.testing.assert_array_equal(N, want_N.numpy())
