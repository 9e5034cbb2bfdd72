"""The port's device encode (crackle_tpu_torch/kernels/encode.py) on the
CPU against the reference's (crackle_tpu/kernels/encode.py, Pallas in
interpret mode) and against crackle_tpu.compress, byte for byte."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crackle_tpu as crackle
from crackle_tpu import native as rnative
from crackle_tpu.kernels import ccl_pallas
from crackle_tpu.kernels import encode as jenc
from crackle_tpu_torch import codec as pcodec
from crackle_tpu_torch.kernels import _build
from crackle_tpu_torch.kernels import encode as enc

from test_jax_encode import DEVICE_ENCODE_CASES, random_slices, random_volume

DTYPES = [np.uint8, np.uint16, np.uint32, np.uint64]
TORCH_OF = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.uint16,
            np.dtype(np.uint32): torch.uint32,
            np.dtype(np.uint64): torch.uint64}
SIGNED_OF = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}

# (B, sy, sx, labels, seed, smoothing passes): smooth slices, a 1-tall and
# a 1-wide batch, constant slices
SLICES = [(3, 16, 16, 4, 0, 2), (4, 24, 17, 5, 1, 3), (2, 1, 9, 3, 2, 0),
          (2, 9, 1, 3, 3, 0), (2, 5, 7, 1, 4, 0)]


@pytest.fixture(scope="module", autouse=True)
def interpret():
  """The reference's Pallas kernels in interpret mode, as its own
  device_encode fixture runs them, once for the module."""
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(ccl_pallas, "INTERPRET", True)
    jax.clear_caches()
    yield
  jax.clear_caches()


def spread(a, dtype):
  """a's labels mapped one to one across the whole range of dtype (an
  odd multiplier modulo 2^bits), so that the high bits, and the sign bit
  of the signed view, are taken."""
  bits = 8 * np.dtype(dtype).itemsize
  mult = (0x9E3779B97F4A7C15 >> (64 - bits)) | 1
  wide = a.astype(np.uint64) * np.uint64(mult)
  return (wide & np.uint64((1 << bits) - 1)).astype(dtype) if bits < 64 \
    else wide


def as_tensor(a):
  """A numpy unsigned array as a CPU tensor of the same unsigned dtype."""
  t = torch.from_numpy(np.ascontiguousarray(a).view(
    SIGNED_OF[a.dtype.itemsize]) if a.dtype.itemsize > 1 else
    np.ascontiguousarray(a))
  return t.view(TORCH_OF[a.dtype]).reshape(a.shape)


def ref_planes(a):
  """The reference's device planes of (B, sy, sx) labels
  (encode_flat_device): int32, or (lo, hi) int32 planes for 64 bits."""
  if a.dtype.itemsize == 8:
    return ((a & 0xffffffff).astype(np.uint32).view(np.int32),
            (a >> np.uint64(32)).astype(np.uint32).view(np.int32))
  return a.astype(np.uint32).view(np.int32)


def ref_ids(a):
  """(B, sy, sx) labels as dense uint32 ids with the same equalities, for
  reference calls that cannot take 64-bit labels without x64."""
  return np.unique(a, return_inverse=True)[1].reshape(a.shape).astype(
    np.uint32)


def ref_tables(a, cc, N):
  """The reference's component label tables as uint64 (its
  encode_flat_device's own combination of the planes' tables)."""
  sx, sy = a.shape[2], a.shape[1]
  planes = ref_planes(a)
  if a.dtype.itemsize == 8:
    lo, hi = (np.asarray(jenc.component_labels(jnp.asarray(p), cc, N, sx, sy))
              .view(np.uint32).astype(np.uint64) for p in planes)
    return lo | (hi << np.uint64(32))
  return np.asarray(jenc.component_labels(
    jnp.asarray(planes), cc, N, sx, sy)).view(np.uint32).astype(np.uint64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SLICES)
def test_labels_to_vcg_matches_reference(case, dtype):
  B, sy, sx, nl, seed, smooth = case
  a = spread(random_slices(B, sy, sx, nl, seed, smooth), dtype)
  with jax.enable_x64(dtype == np.uint64):
    want = np.asarray(jenc.labels_to_vcg(jnp.asarray(a), sx, sy))
  got = enc.labels_to_vcg(as_tensor(a))
  assert got.dtype == torch.int32 and got.shape == (B, sy, sx)
  np.testing.assert_array_equal(got.reshape(B, -1).numpy(), want)


@pytest.mark.parametrize("case", SLICES + [(2, 20, 20, 6, 5, 0)])
def test_ccl_from_labels_matches_reference(case):
  B, sy, sx, nl, seed, smooth = case
  a = random_slices(B, sy, sx, nl, seed, smooth)
  cc, N = jenc.ccl_from_labels(jnp.asarray(a), sx, sy)
  got_cc, got_N = enc.ccl_from_labels(as_tensor(spread(a, np.uint64)))
  np.testing.assert_array_equal(got_cc.numpy(), np.asarray(cc))
  np.testing.assert_array_equal(got_N.numpy(), np.asarray(N))
  np.testing.assert_array_equal(got_N.numpy(), np.asarray(cc).max(1) + 1)


@pytest.mark.parametrize("shape", [(0, 4, 4), (3, 0, 4), (3, 4, 0)])
def test_ccl_from_labels_of_empty_batches(shape):
  cc, N = enc.ccl_from_labels(torch.zeros(shape, dtype=torch.uint32))
  assert cc.shape == (shape[0], shape[1] * shape[2]) and cc.dtype == torch.int32
  assert N.tolist() == [0] * shape[0] and N.dtype == torch.int32


@pytest.mark.parametrize("dtype", DTYPES)
def test_format_stats_matches_reference(dtype):
  a = spread(random_slices(1, 8, 8, 3, seed=2, smooth=1), dtype).ravel()
  with jax.enable_x64(dtype == np.uint64):
    pairs, mx = jenc.format_stats(jnp.asarray(a))
  got_pairs, got_mx = enc.format_stats(as_tensor(a))
  assert int(got_pairs) == int(pairs)
  assert int(got_mx.numpy().astype(np.int64).view(np.uint64)) == int(mx)
  assert int(mx) == int(a.max())


def test_format_stats_of_nothing():
  pairs, mx = enc.format_stats(torch.zeros(0, dtype=torch.uint16))
  assert int(pairs) == 0 and int(mx) == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [SLICES[0], SLICES[3], SLICES[4]])
def test_component_labels_match_reference(case, dtype):
  """The whole (B, cap_n) table, pad included, equals the reference's."""
  B, sy, sx, nl, seed, smooth = case
  a = spread(random_slices(B, sy, sx, nl, seed, smooth), dtype)
  cc, N = jenc.ccl_from_labels(jnp.asarray(ref_ids(a)), sx, sy)
  want = ref_tables(a, cc, N)
  t = as_tensor(a)
  got_cc, got_N = enc.ccl_from_labels(t)
  got = enc.component_labels(t, got_cc, got_N)
  assert got.dtype == torch.int64
  np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [SLICES[1], SLICES[2]])
def test_encode_stage1_matches_reference(case, dtype):
  B, sy, sx, nl, seed, smooth = case
  a = spread(random_slices(B, sy, sx, nl, seed, smooth), dtype)
  planes = ref_planes(a)
  wide = dtype == np.uint64
  ref = jenc._encode_stage1(
    tuple(jnp.asarray(p) for p in planes) if wide else jnp.asarray(planes),
    sx, sy, wide)
  vcg, cc, N, crcs, pairs = enc._encode_stage1(as_tensor(a))
  np.testing.assert_array_equal(vcg.reshape(B, -1).numpy(), np.asarray(ref[0]))
  np.testing.assert_array_equal(cc.numpy(), np.asarray(ref[1]))
  np.testing.assert_array_equal(N.numpy(), np.asarray(ref[2]))
  np.testing.assert_array_equal(crcs.numpy(),
                                np.asarray(ref[3]).astype(np.int64))
  assert int(pairs) == int(ref[4])


@pytest.mark.parametrize("n", [1, 7, 16, 17 * 24])
def test_pack_vcg_nibbles_matches_reference(n):
  v = np.random.RandomState(n).randint(0, 16, (3, n)).astype(np.uint8)
  want = np.asarray(jenc._pack_vcg_nibbles(jnp.asarray(v)))
  for t in (torch.from_numpy(v), torch.from_numpy(v.astype(np.int32))):
    got = enc._pack_vcg_nibbles(t)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
  np.testing.assert_array_equal(enc._unpack(want[1], n), v[1])


@pytest.mark.parametrize("case", [DEVICE_ENCODE_CASES[0],
                                  DEVICE_ENCODE_CASES[4]])
def test_assemble_flat_stream_matches_reference(case):
  """The host tail from the reference's stage 1: the port's, fed the
  packed VCG, writes the reference's bytes from the unpacked one."""
  shape, nl, seed, smooth, dtype = case
  vol = random_volume(shape, nl, seed, smooth, dtype)
  sx, sy, sz = shape
  zyx = np.ascontiguousarray(vol.transpose(2, 1, 0))
  planes = ref_planes(zyx)
  wide = dtype == np.uint64
  vcg, cc, N, crcs, pairs = jenc._encode_stage1(
    tuple(jnp.asarray(p) for p in planes) if wide else jnp.asarray(planes),
    sx, sy, wide)
  tables = ref_tables(zyx, cc, N)
  N, crcs = np.asarray(N), np.asarray(crcs).astype(np.uint32)
  vcg = np.asarray(vcg)
  kw = dict(data_width=vol.itemsize, fortran_order=True)
  # the reference's native loader gives None to threads that call it
  # while another loads it, so load it first, as its encode_flat_device
  # does, before its trace threads call it
  assert rnative.available()
  want = jenc.assemble_flat_stream(vcg, tables, N, crcs, int(pairs), sx, sy,
                                   sz, **kw)
  assert want == crackle.compress(vol)
  packed = enc._pack_vcg_nibbles(torch.from_numpy(vcg.copy()))
  for p in (packed, packed.numpy()):
    assert enc.assemble_flat_stream(p, tables, N, crcs, int(pairs), sx, sy,
                                    sz, **kw) == want


@pytest.mark.parametrize("as_torch", [False, True])
@pytest.mark.parametrize("shape,nl,seed,smooth,dtype", DEVICE_ENCODE_CASES)
def test_encode_flat_device_byte_identity(shape, nl, seed, smooth, dtype,
                                          as_torch):
  vol = random_volume(shape, nl, seed, smooth, dtype)
  want = crackle.compress(vol)
  got = enc.encode_flat_device(as_tensor(vol) if as_torch else vol,
                               device="cpu")
  assert got == want


def test_encode_flat_device_c_order():
  vol = np.ascontiguousarray(random_volume((20, 13, 5), 6, 58, 3, np.uint16))
  got = enc.encode_flat_device(vol, fortran_order=False, device="cpu")
  assert got == crackle.compress(vol)
  assert not pcodec.header(got).fortran_order


@pytest.mark.parametrize("slices", [1, 2, 3])
def test_stage1_batches_count_seams_once(monkeypatch, slices):
  """Batches of 1, 2 and 3 slices: the pixel pair across each slice seam,
  a batch seam or not, counts once."""
  vol = random_volume((6, 5, 7), 2, 59)
  vol[0, 0, 1:] = vol[-1, -1, :-1]  # every slice seam is a pair
  flat = vol.ravel("F")
  monkeypatch.setattr(enc, "STAGE1_PIX", slices * 6 * 5)
  zyx = as_tensor(np.ascontiguousarray(vol.transpose(2, 1, 0)))
  assert enc._stage1_volume(zyx)[4] == \
    int(np.count_nonzero(flat[1:] == flat[:-1]))
  assert enc.encode_flat_device(vol, device="cpu") == crackle.compress(vol)


def test_encode_declines_with_a_reason(caplog):
  caplog.set_level(logging.WARNING, logger="crackle_tpu_torch.engine")
  assert enc.encode_flat_device(np.zeros((4, 0, 2), np.uint32),
                                device="cpu") is None
  # 2^31 pixels a slice, as a view of one byte: declined before any copy
  huge = torch.zeros(1, dtype=torch.uint8).expand(1 << 16, 1 << 15, 1)
  assert enc.encode_flat_device(huge) is None
  assert enc.encode_flat_device(np.zeros((2, 2, 2), np.float32)) is None
  msgs = [r.getMessage() for r in caplog.records]
  assert any("an empty volume" in m for m in msgs)
  assert any("2147483648 pixels a slice" in m for m in msgs)
  assert any("float32" in m for m in msgs)


@pytest.mark.parametrize("dtype", DTYPES)
def test_compress_of_a_tensor(dtype):
  vol = spread(random_volume((18, 11, 4), 5, 60, 3), dtype)
  want = crackle.compress(vol)
  launches = dict(_build.LAUNCHES)
  assert pcodec.compress(as_tensor(vol)) == want
  # in its (z, y, x) rows, as DeviceStream.decode_window leaves labels
  rows = as_tensor(np.ascontiguousarray(vol.transpose(2, 1, 0)).reshape(4, -1))
  assert pcodec.compress(rows.reshape(4, 11, 18).permute(2, 1, 0)) == want
  # the plain versions on the CPU: no kernel launched
  assert dict(_build.LAUNCHES) == launches


@pytest.mark.parametrize("order", ["F", "C"])
def test_compress_under_torch_engine(order):
  vol = random_volume((21, 14, 3), 6, 61, 3)
  vol = np.asfortranarray(vol) if order == "F" else np.ascontiguousarray(vol)
  pcodec.set_engine("torch", device="cpu")
  try:
    got = pcodec.compress(vol)
  finally:
    pcodec.set_engine("auto")
  assert got == crackle.compress(vol)
  assert pcodec.header(got).fortran_order == (order == "F")


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32,
                                   torch.int64])
def test_compress_of_a_signed_tensor_raises(dtype):
  with pytest.raises(TypeError):
    pcodec.compress(torch.zeros((4, 4, 2), dtype=dtype))


@pytest.mark.parametrize("kw", [dict(allow_pins=1),
                                dict(markov_model_order=5)])
def test_compress_of_a_tensor_with_pins_or_markov(kw):
  """Pins and markov requests take the host path with the reference's
  bytes for a device array: its labels in F order."""
  vol = random_volume((24, 20, 4), 4, 62, 4)
  t = as_tensor(np.ascontiguousarray(vol))
  assert pcodec.compress(t, **kw) == crackle.compress(np.asfortranarray(vol),
                                                     **kw)


def test_compress_of_a_2d_tensor():
  img = random_volume((15, 9), 4, 63, 2, np.uint16)
  got = pcodec.compress(as_tensor(np.ascontiguousarray(img)))
  assert got == crackle.compress(np.asfortranarray(img))
  np.testing.assert_array_equal(pcodec.decompress(got)[:, :, 0], img)


def test_compress_on_a_device_raises_where_encode_declines(monkeypatch):
  """Labels on a device other than the CPU never reach the host encoder
  through a decline: compress raises with the reason."""
  monkeypatch.setattr(enc.native, "available", lambda: False)
  t = torch.zeros((4, 4, 2), dtype=torch.uint32, device="meta")
  with pytest.raises(RuntimeError, match="native trace library is missing"):
    pcodec.compress(t)


def test_compress_of_a_cpu_tensor_without_the_native_library(monkeypatch):
  """On the CPU a decline of the device encode takes the host path, with
  the reference's bytes."""
  vol = random_volume((20, 13, 3), 5, 64, 3, np.uint16)
  monkeypatch.setattr(enc.native, "available", lambda: False)
  assert pcodec.compress(as_tensor(vol)) == crackle.compress(vol)
