"""Condensed-pins streams and CrackleDeviceArray on the CPU: the port's
pins tables, decode_slices_full_pins, pins DeviceStream and array facade
against the JAX package (Pallas in interpret mode), its host facade and
the volume itself. Every comparison is exact."""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import crackle_tpu as crackle
from crackle_tpu.kernels import ccl_pallas
from crackle_tpu.kernels import decode as jdec
from crackle_tpu.kernels import engine as jeng
import crackle_tpu_torch as ct
from crackle_tpu_torch.kernels import engine as teng

from test_jax_decode import random_volume

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pins_volume(dtype=np.uint32):
  """The volume of test_jax_decode.test_pins_device_stream_windows:
  smooth enough that allow_pins=1 picks condensed pins."""
  rng = np.random.RandomState(9)
  vol = rng.randint(0, 4, size=(20, 18, 10)).astype(np.uint32)
  for _ in range(12):
    ax = rng.randint(0, 3)
    m = rng.rand(*vol.shape) < 0.6
    vol = np.where(m, np.roll(vol, 1, axis=ax), vol)
  return np.asfortranarray(vol.astype(dtype))


@pytest.fixture
def interpret(monkeypatch):
  monkeypatch.setattr(ccl_pallas, "INTERPRET", True)


@pytest.fixture(scope="module")
def pins_binary():
  binary = crackle.compress(pins_volume(), allow_pins=1)
  assert crackle.header(binary).label_format == 2
  return binary


def as_volume(labels, shape):
  sx, sy, sz = shape
  return labels.numpy().reshape(sz, sy, sx).transpose(2, 1, 0)


@pytest.mark.parametrize("z0,z1", [(0, 10), (2, 7)])
def test_pins_tables_match_reference(pins_binary, z0, z1):
  head = crackle.header(pins_binary)
  want = jeng._pins_device_tables(head, pins_binary, z0, z1)
  got = teng._pins_device_tables(head, pins_binary, z0, z1)
  for g, w in zip(got[:4], want[:4]):
    np.testing.assert_array_equal(g, w)
  assert got[4:] == want[4:]


@pytest.mark.parametrize("cap_n", [None, 4096])
def test_decode_slices_full_pins_matches_jax(interpret, pins_binary, cap_n):
  """The v2 plant path (the stream's own cap_n) and the else-branch past
  PAINT_CAP_N (ccl_paint, then a gather) against the reference, fed the
  same tables through params_from_jax."""
  head = crackle.header(pins_binary)
  inputs = jeng.prepare_slice_inputs(pins_binary, 0, head.sz)
  tables = jeng._pins_device_tables(head, pins_binary, 0, head.sz)
  cap_n = cap_n or tables[5]
  perm = bool(head.crack_format)
  want = jdec.decode_slices_full_pins(
    *(jnp.asarray(inputs[k])
      for k in ("packed", "nbytes", "nodes", "n_chains")),
    *(jnp.asarray(a) for a in tables[:4]), jnp.int32(tables[4]),
    sx=head.sx, sy=head.sy, permissible=perm, cap_n=cap_n)
  t = ct.params_from_jax(inputs, device="cpu", pins=tables)
  got = ct.decode_slices_full_pins(
    t["packed"], t["nbytes"], t["nodes"], t["n_chains"], *t["pins"][:5],
    sx=head.sx, sy=head.sy, permissible=perm, cap_n=cap_n)
  assert got[0].dtype == torch.uint32
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pins_device_stream_windows(interpret, pins_binary):
  """Mirrors test_jax_decode.test_pins_device_stream_windows: the pins
  DeviceStream against the reference's and the volume."""
  vol = pins_volume()
  want_stream = jeng.upload_stream(pins_binary)
  stream = ct.upload_stream(pins_binary, "cpu")
  assert stream is not None and stream.pins is not None and stream.T is None
  assert stream.nbytes_device == want_stream.nbytes_device + 8 * vol.shape[2]
  for z0, z1 in [(0, 10), (3, 7), (9, 10)]:
    labels, cc, N = stream.decode_window(z0, z1, check_crcs=True)
    np.testing.assert_array_equal(as_volume(labels, (20, 18, z1 - z0)),
                                  vol[:, :, z0:z1])
    for g, w in zip((labels, cc, N), want_stream.decode_window(z0, z1)):
      np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pins_stream_crc_check(pins_binary):
  stream = ct.upload_stream(pins_binary, "cpu")
  stream.crcs[4] ^= 0x10
  with pytest.raises(ct.FormatError, match="z=4"):
    stream.decode_window(0, 10, check_crcs=True)


def test_pins_bench_volume_window():
  """Two slices of the committed 256^2 x 128 pins bench volume against
  the host decoder."""
  path = os.path.join(ROOT, "bench_data",
                      "connectomics_v2_pins_256x256x128.ckl")
  with open(path, "rb") as f:
    binary = f.read()
  assert crackle.header(binary).label_format == 2
  labels, _, _ = ct.upload_stream(binary, "cpu").decode_window(
    60, 62, check_crcs=True)
  want = crackle.codec.decompress_range(binary, 60, 62)
  np.testing.assert_array_equal(as_volume(labels, (256, 256, 2)), want)


# -- CrackleDeviceArray ------------------------------------------------

KEYS = [np.s_[:, :, 2], np.s_[3:10, 4:12, 1:5], np.s_[..., 0], 5,
        np.s_[2:5], np.s_[1:19:3, :, 3:6:2], np.s_[-3:, 4, 5]]
# the reference's facade decodes in interpret mode: slow, so fewer keys
REF_KEYS = [np.s_[3:10, 4:12, 1:5], np.s_[..., 0]]


@pytest.mark.parametrize("kind", ["flat", "flat_u64", "pins"])
def test_device_array_matches_reference(interpret, kind):
  """Mirrors test_api_surface.test_crackle_device_array: cutouts equal
  crackle_tpu.CrackleDeviceArray's, CrackleArray's and the volume's."""
  if kind == "pins":
    vol = pins_volume()
    binary = crackle.compress(vol, allow_pins=1)
  else:
    vol = random_volume((24, 20, 6), 8, 21, 4)
    if kind == "flat_u64":
      vol = np.asfortranarray(vol.astype(np.uint64) + np.uint64(1 << 40))
    binary = crackle.compress(vol)
  arr = ct.CrackleDeviceArray(binary, "cpu")
  ref = crackle.CrackleDeviceArray(binary)
  host = crackle.CrackleArray(binary)
  assert arr.shape == vol.shape and arr.dtype == vol.dtype
  assert arr.ndim == 3 and arr.nbytes_device > 0
  assert arr.header().sz == vol.shape[2]
  for key in KEYS:
    got = arr[key]
    assert got.dtype == (torch.uint64 if kind == "flat_u64"
                         else torch.uint32)
    np.testing.assert_array_equal(got.numpy(), host[key])
  for key in REF_KEYS:
    np.testing.assert_array_equal(arr[key].numpy(), np.asarray(ref[key]))
  np.testing.assert_array_equal(arr[3:10, 4:12, 1:5].numpy(),
                                vol[3:10, 4:12, 1:5])
  np.testing.assert_array_equal(arr.labels(), np.unique(vol))
  assert arr.num_labels() == len(np.unique(vol))
  assert arr.contains(int(vol[0, 0, 0]))
  arr.check_crcs()


def test_device_array_declines_like_upload_stream():
  many = crackle.compress(random_volume((64, 64, 2), 12, 5, 0))
  with pytest.raises(ValueError, match="not eligible"):
    ct.CrackleDeviceArray(many, "cpu")
