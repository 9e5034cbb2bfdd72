"""The slice end to end on the CPU: the port's DeviceStream and
decode_slices_to_ccl against the JAX engine (Pallas in interpret mode)
and the volume itself."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import crackle_tpu as crackle
from crackle_tpu.kernels import ccl_pallas
from crackle_tpu.kernels import decode as jdec
from crackle_tpu.kernels import engine as jeng
from crackle_tpu.ops.ccl import connected_components_slice
import crackle_tpu_torch as ct

from test_jax_decode import blocky_volume, random_volume

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def as_volume(labels, shape):
  sx, sy, sz = shape
  return labels.numpy().reshape(sz, sy, sx).transpose(2, 1, 0)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_device_stream_matches_jax_and_volume(monkeypatch, dtype):
  monkeypatch.setattr(ccl_pallas, "INTERPRET", True)
  vol = random_volume((20, 16, 6), 9, 7, 4).astype(dtype)
  if dtype == np.uint64:
    vol = np.asfortranarray(vol + np.uint64(0x1_0000_0000))
  binary = crackle.compress(vol)
  want_stream = jeng.upload_stream(binary)
  stream = ct.upload_stream(binary, "cpu")
  assert stream is not None and stream.device == torch.device("cpu")
  for z0, z1 in [(0, 6), (2, 5)]:
    labels, cc, N = stream.decode_window(z0, z1, check_crcs=True)
    assert labels.dtype == (torch.uint64 if dtype == np.uint64
                            else torch.uint32)
    np.testing.assert_array_equal(as_volume(labels, (20, 16, z1 - z0)),
                                  vol[:, :, z0:z1])
    w_labels, w_cc, w_N = want_stream.decode_window(z0, z1)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(w_labels))
    np.testing.assert_array_equal(cc.numpy(), np.asarray(w_cc))
    np.testing.assert_array_equal(N.numpy(), np.asarray(w_N))


def test_device_stream_markov():
  vol = random_volume((24, 20, 5), 6, 24, 5)
  binary = crackle.compress(vol, markov_model_order=3)
  stream = ct.upload_stream(binary, "cpu")
  labels, _, _ = stream.decode_window(0, 5, check_crcs=True)
  np.testing.assert_array_equal(as_volume(labels, vol.shape), vol)


def test_decode_slices_to_ccl_matches_jax():
  vol = random_volume((32, 28, 4), 6, 13, 5)
  binary = crackle.compress(vol)
  inputs = jeng.prepare_slice_inputs(binary, 0, 4)
  head = inputs["head"]
  perm = bool(head.crack_format)
  want_cc, want_N = jdec.decode_slices_to_ccl(
    *(jnp.asarray(inputs[k])
      for k in ("packed", "nbytes", "nodes", "n_chains")),
    sx=head.sx, sy=head.sy, permissible=perm)
  t = ct.params_from_jax(inputs, device="cpu")
  cc, N = ct.decode_slices_to_ccl(t["packed"], t["nbytes"], t["nodes"],
                                  t["n_chains"], head.sx, head.sy, perm)
  np.testing.assert_array_equal(cc.numpy(), np.asarray(want_cc))
  np.testing.assert_array_equal(N.numpy(), np.asarray(want_N))


def test_decode_window_ccl_device_matches_oracle():
  vol = random_volume((32, 32, 3), 6, 17, 5)
  cc, N, head = ct.decode_window_ccl_device(crackle.compress(vol), 0, 3,
                                            "cpu")
  for z in range(3):
    want, n = connected_components_slice(
      np.ascontiguousarray(vol[:, :, z].T).ravel(), 32, 32)
    np.testing.assert_array_equal(cc[z].numpy(), want.astype(np.int32))
    assert int(N[z]) == n


def test_device_stream_crc_check():
  vol = random_volume((32, 24, 4), 7, 21, 4)
  stream = ct.upload_stream(crackle.compress(vol), "cpu")
  assert stream.crcs is not None
  stream.decode_window(0, 4, check_crcs=True)
  stream.crcs[2] ^= 0x1
  with pytest.raises(ct.FormatError, match="z=2"):
    stream.decode_window(0, 4, check_crcs=True)
  # the gate is opt-in, as in the reference
  stream.decode_window(0, 4)


def test_upload_declines_where_the_reference_does(monkeypatch):
  monkeypatch.setattr(ccl_pallas, "INTERPRET", True)
  many = crackle.compress(random_volume((64, 64, 2), 12, 5, 0))
  assert jeng.upload_stream(many) is None  # cap_n > PAINT_CAP_N
  assert ct.upload_stream(many, "cpu") is None


def test_upload_declines_wide_pins_streams(monkeypatch, caplog):
  """Pins streams whose labels are stored wider than 32 bits are
  declined by both packages, with the reason logged. (The volume of
  test_jax_decode.test_pins_device_stream_windows, offset by 2^40.)"""
  monkeypatch.setattr(ccl_pallas, "INTERPRET", True)
  rng = np.random.RandomState(9)
  vol = rng.randint(0, 4, size=(20, 18, 10)).astype(np.uint32)
  for _ in range(12):
    ax = rng.randint(0, 3)
    m = rng.rand(*vol.shape) < 0.6
    vol = np.where(m, np.roll(vol, 1, axis=ax), vol)
  vol = np.asfortranarray(vol.astype(np.uint64) + np.uint64(1 << 40))
  pins = crackle.compress(vol, allow_pins=1)
  head = crackle.header(pins)
  assert head.label_format == 2 and head.stored_data_width == 8
  assert jeng.upload_stream(pins) is None
  assert ct.upload_stream(pins, "cpu") is None
  assert "stored width > 4" in caplog.text
  with pytest.raises(ValueError, match="not eligible"):
    ct.CrackleDeviceArray(pins, "cpu")


def test_upload_to_cuda_without_cuda_raises():
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present")
  binary = crackle.compress(random_volume((8, 8, 2), 3, 1, 0))
  with pytest.raises(RuntimeError, match="CUDA"):
    ct.upload_stream(binary, "cuda")
  with pytest.raises(RuntimeError, match="CUDA"):
    ct.decode_window_ccl_device(binary, 0, 2, torch.device("cuda"))


def test_port_never_imports_the_reference():
  """A child process compresses with the port's codec (a tensor too)
  and runs the flat, pins, markov, analytics, array, window-decode,
  torch-engine decompress and compact paths on the CPU; no module of JAX
  or of crackle_tpu may be imported."""
  code = (
    "import sys, numpy as np\n"
    "import crackle_tpu_torch as ct\n"
    "from crackle_tpu_torch import codec\n"
    "from crackle_tpu_torch.kernels import replay\n"
    "rng = np.random.RandomState(0)\n"
    "vol = np.asfortranarray(rng.randint(0, 3, (12, 10, 3)).astype("
    "np.uint32))\n"
    "flat = codec.compress(vol)\n"
    "assert (codec.decompress(flat) == vol).all()\n"
    "import torch\n"
    "t = torch.from_numpy(vol.view(np.int32)).view(torch.uint32)\n"
    "assert codec.compress(t) == flat\n"
    "s = ct.upload_stream(flat, 'cpu')\n"
    "lab, cc, N = s.decode_window(0, 3, check_crcs=True)\n"
    "got = lab.numpy().reshape(3, 10, 12).transpose(2, 1, 0)\n"
    "assert (got == vol).all()\n"
    "mkv = codec.compress(vol, markov_model_order=5)\n"
    "lab, _, _ = ct.upload_stream(mkv, 'cpu').decode_window(0, 3)\n"
    "assert (lab.numpy().reshape(3, 10, 12).transpose(2, 1, 0) == vol).all()\n"
    "blocky = np.asfortranarray(np.repeat(np.repeat(np.repeat(\n"
    "  rng.randint(0, 3, (4, 4, 2)), 5, 0), 5, 1), 2, 2).astype(np.uint32))\n"
    "pins = codec.compress(blocky, allow_pins=1)\n"
    "assert codec.header(pins).label_format == 2\n"
    "assert (codec.decompress(pins) == blocky).all()\n"
    "arr = ct.CrackleDeviceArray(pins, 'cpu')\n"
    "assert (arr[:, :, 1:3].numpy() == blocky[:, :, 1:3]).all()\n"
    "arr.check_crcs()\n"
    "assert arr.point_cloud()\n"
    "vc = ct.CrackleDeviceArray(flat, 'cpu').voxel_counts()\n"
    "assert vc == {int(k): int((vol == k).sum()) for k in np.unique(vol)}\n"
    "assert ct.centroids(flat, device='cpu')\n"
    "assert ct.bounding_boxes(pins, device='cpu')\n"
    "assert (ct.decode_window(flat, 0, 3, device='cpu') == vol).all()\n"
    "codec.set_engine('torch', device='cpu')\n"
    "assert (codec.decompress(pins) == blocky).all()\n"
    "assert (codec.decompress(mkv, label=1) == (vol == 1)).all()\n"
    "codec.set_engine('auto')\n"
    "replay.CANCEL_COMPACT = True\n"
    "lab, _, _ = ct.upload_stream(flat, 'cpu').decode_window(0, 3)\n"
    "assert (lab.numpy().reshape(3, 10, 12).transpose(2, 1, 0) == vol).all()\n"
    "print(sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'crackle_tpu')))\n")
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  env["PYTHONPATH"] = ROOT
  res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=300)
  assert res.returncode == 0, res.stderr
  assert res.stdout.strip() == "[]"
