"""The port's analytics host tail and device routes
(crackle_tpu_torch/ops/analytics.py: voxel_connectivity_graph, contacts,
each, mode_pooling_2x2x1, connected_components_3d, cache_meta) and the
engine's VCG and labels windows, against crackle_tpu on its host engine.

Each function runs under set_engine('numpy') (the reference's host
loops) and under set_engine('torch', device="cpu") (the device routes on
the plain versions), the latter also in windows of 2 slices (the z-bit
and contact seams cross windows) and with MAX_DEVICE_CAP shrunk (the VCG
painted from chain-aligned pieces). Every comparison is exact: arrays
and bytes equal, dicts ==."""
import logging

import numpy as np
import pytest
import torch

import crackle_tpu as crackle
from crackle_tpu import codec as rcodec
from crackle_tpu import operations as rops
from crackle_tpu.ops import analytics as RA
import crackle_tpu_torch as ct
from crackle_tpu_torch import codec as pcodec
from crackle_tpu_torch import operations as tops
from crackle_tpu_torch.kernels import engine as peng
from crackle_tpu_torch.ops import analytics as TA

from test_codec import random_volume
from test_torch_operations import STREAMS, stream_of
from test_torch_window import islands, nuclei_volume

# the device routes' cases: host loop, device route, device route in
# windows of 2 slices
MODES = ["numpy", "torch", "torch, windows of 2"]
ANISOTROPY = [(1, 1, 1), (4, 4, 40), (0.3, 0.7, 1.1)]


def permissible_stream():
  """Label noise, few equal neighbours: a permissible crack format."""
  vol = random_volume((16, 14, 5), 3, seed=2)
  binary = crackle.compress(vol)
  assert crackle.header(binary).crack_format == 1
  return vol, binary


def streams(name):
  return permissible_stream() if name == "permissible" else stream_of(name)


NAMES = list(STREAMS) + ["permissible"]


@pytest.fixture
def mode(request, monkeypatch, caplog):
  """Sets the port's engine (and window) for a MODES entry and the
  reference's host engine; on exit, no device route may have declined."""
  monkeypatch.setattr(rcodec, "_ENGINE", "numpy")
  if request.param == "numpy":
    pcodec.set_engine("numpy")
  else:
    pcodec.set_engine("torch", device="cpu")
  if request.param.endswith("windows of 2"):
    monkeypatch.setattr(TA, "_DEVICE_WINDOW", 2)
  caplog.set_level(logging.WARNING)
  yield request.param
  pcodec.set_engine("auto")
  assert "declined" not in caplog.text


def vcg_ref(binary, c):
  return rops.voxel_connectivity_graph(binary, connectivity=c)


@pytest.mark.parametrize("mode", MODES, indirect=True)
@pytest.mark.parametrize("connectivity", [4, 6])
@pytest.mark.parametrize("name", NAMES)
def test_vcg_matches_reference(mode, name, connectivity):
  _, binary = streams(name)
  want = vcg_ref(binary, connectivity)
  got = tops.voxel_connectivity_graph(binary, connectivity=connectivity)
  assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(
    ct.voxel_connectivity_graph(binary, connectivity), want)


def test_vcg_connectivity_must_be_4_or_6():
  _, binary = stream_of("flat u32")
  for mod in (rops, tops):
    with pytest.raises(ValueError, match="4 and 6"):
      mod.voxel_connectivity_graph(binary, connectivity=8)


@pytest.mark.parametrize("mode", MODES, indirect=True)
@pytest.mark.parametrize("anisotropy", ANISOTROPY)
@pytest.mark.parametrize("name", NAMES)
def test_contacts_match_reference(mode, name, anisotropy):
  _, binary = streams(name)
  want = rops.contacts(binary, anisotropy=anisotropy)
  got = tops.contacts(binary, anisotropy=anisotropy)
  assert got == want
  assert all(type(k[0]) is int and type(v) is float for k, v in got.items())


@pytest.mark.parametrize("mode", MODES[1:], indirect=True)
@pytest.mark.parametrize("name", ["islands", "nuclei"])
def test_vcg_and_contacts_through_the_split(mode, monkeypatch, name):
  """Slices past MAX_DEVICE_CAP (1024 codepoints): the VCG painted from
  chain-aligned pieces, and the labels through the gather paint."""
  monkeypatch.setattr(peng, "MAX_DEVICE_CAP", 1024)
  vol = islands(4, 96) if name == "islands" else nuclei_volume(120, 96, 5)
  binary = crackle.compress(vol)
  assert not peng._device_cap_ok(peng.prepare_slice_inputs(binary, 0, 3))
  for c in (4, 6):
    np.testing.assert_array_equal(tops.voxel_connectivity_graph(binary, c),
                                  vcg_ref(binary, c))
  for anisotropy in ANISOTROPY[1:]:
    assert tops.contacts(binary, anisotropy) == rops.contacts(binary,
                                                              anisotropy)


def test_declined_windows_take_the_host_loop(monkeypatch, caplog):
  """A markov stream whose slices would need the split: the engine
  declines, the reason is logged, and the host loop gives the result."""
  monkeypatch.setattr(rcodec, "_ENGINE", "numpy")
  monkeypatch.setattr(peng, "MAX_DEVICE_CAP", 1024)
  binary = crackle.compress(islands(4, 96), markov_model_order=3)
  pcodec.set_engine("torch", device="cpu")
  try:
    for c in (4, 6):
      np.testing.assert_array_equal(tops.voxel_connectivity_graph(binary, c),
                                    vcg_ref(binary, c))
    assert tops.contacts(binary) == rops.contacts(binary)
  finally:
    pcodec.set_engine("auto")
  assert "decode_window_vcg_device: declined" in caplog.text
  assert "decode_window_labels_device: declined" in caplog.text
  assert "contacts: the device route declined" in caplog.text


@pytest.mark.parametrize("mode", MODES[:2], indirect=True)
@pytest.mark.parametrize("top", [0, 2 ** 31, 2 ** 63 - 3, 2 ** 64 - 9])
def test_contacts_of_wide_labels(mode, top):
  """u64 labels near and past 2^63 (their order is unsigned in the
  result), beside labels below 2^32 and background 0."""
  vol = random_volume((10, 9, 4), 5, seed=8, smooth=2).astype(np.uint64)
  vol = np.where(vol >= 3, vol + np.uint64(top), vol)
  binary = crackle.compress(np.asfortranarray(vol))
  want = rops.contacts(binary, (4, 4, 40))
  assert tops.contacts(binary, (4, 4, 40)) == want
  assert len(want) > 3


@pytest.mark.parametrize("mode", MODES[:2], indirect=True)
def test_structure_equal_matches_reference(mode):
  vol, binary = stream_of("flat u32")
  pairs = [(binary, rops.renumber(binary, start=3)[0]),
           (binary, crackle.compress(vol, allow_pins=1)),
           (binary, crackle.compress(np.asfortranarray(vol[::-1])))]
  for a, b in pairs:
    assert tops.structure_equal(a, b) == rops.structure_equal(a, b)
  assert [tops.structure_equal(*p) for p in pairs] == [True, True, False]


@pytest.mark.parametrize("mode", MODES[:2], indirect=True)
@pytest.mark.parametrize("name", NAMES[:-2])
def test_each_matches_reference(mode, name):
  """each's (label, image) pairs, cropped, whole, for a subset of the
  labels and in multi mode."""
  _, binary = stream_of(name)
  uniq = [int(u) for u in crackle.labels(binary)]
  for kw in ({}, {"crop": False}, {"labels": uniq[1:3] + [10 ** 6]},
             {"multi": True}):
    want = list(RA.each(binary, **kw))
    got = list(ct.each(binary, **kw))
    assert len(got) == len(want) == len(ct.each(binary, **kw))
    for g, w in zip(got, want):
      assert g[:-1] == w[:-1]
      assert g[-1].dtype == w[-1].dtype
      assert g[-1].flags.f_contiguous == w[-1].flags.f_contiguous
      np.testing.assert_array_equal(g[-1], w[-1])


@pytest.mark.parametrize("mode", MODES[:2], indirect=True)
@pytest.mark.parametrize("name", NAMES[:-2] + ["permissible"])
def test_mode_pooling_matches_reference(mode, name):
  """The pooled per-slice streams and their zstack, byte for byte."""
  vol, binary = streams(name)
  got = TA.mode_pooling_2x2x1(binary)
  assert got == RA.mode_pooling_2x2x1(binary)
  assert tops.mode_pooling_2x2x1(binary) == rops.mode_pooling_2x2x1(binary)
  assert TA.mode_pooling_2x2x1(binary, parallel=1) == got
  a = np.arange(20, dtype=np.uint16).reshape(4, 5) % 3
  np.testing.assert_array_equal(TA._mode_2x2(a), RA._mode_2x2(a))


@pytest.mark.parametrize("mode", MODES[:2], indirect=True)
@pytest.mark.parametrize("connectivity", [6, 26])
@pytest.mark.parametrize("name", NAMES[:-2] + ["permissible"])
def test_connected_components_matches_reference(mode, name, connectivity):
  """The labelled stream's bytes and the component -> label mapping,
  multilabel and binary_image."""
  _, binary = streams(name)
  for kw in ({}, {"return_mapping": True}, {"binary_image": True},
             {"binary_image": True, "return_mapping": True}):
    want = rops.connected_components(binary, connectivity, **kw)
    got = tops.connected_components(binary, connectivity, **kw)
    assert got == want
  with pytest.raises(ValueError, match="6 or 26"):
    TA.connected_components_3d(binary, connectivity=18)


@pytest.mark.parametrize("mode", MODES[:2], indirect=True)
@pytest.mark.parametrize("name", ["flat u32", "flat u64", "pins",
                                  "one slice", "empty"])
def test_cache_meta_matches_reference(mode, name, tmp_path):
  """The parquet sidecar's table, and its file read back."""
  import pyarrow.parquet as pq
  _, binary = stream_of(name)
  want = RA.cache_meta(binary, str(tmp_path / "ref.parquet"))
  got = ct.cache_meta(binary, str(tmp_path / "port.parquet"))
  assert got.equals(want)
  assert pq.read_table(str(tmp_path / "port.parquet")).equals(
    pq.read_table(str(tmp_path / "ref.parquet")))


@pytest.mark.parametrize("name", ["flat u32", "flat u64", "C order", "pins",
                                  "markov-3", "one slice", "permissible"])
def test_vcg_window_matches_host_slices(name):
  """decode_window_vcg_device, cast to uint8, is codec.decode_slice_vcg
  of each slice (crack-format complement applied), on any window."""
  _, binary = streams(name)
  sz = crackle.header(binary).sz
  for z0, z1 in ((0, sz), (sz - 1, sz)):
    vcg = ct.decode_window_vcg_device(binary, z0, z1, device="cpu")
    assert vcg.dtype == torch.int32
    for i, z in enumerate(range(z0, z1)):
      np.testing.assert_array_equal(
        vcg[i].to(torch.uint8).numpy().ravel(),
        pcodec.decode_slice_vcg(binary, z))


@pytest.mark.parametrize("name", ["flat u32", "flat u64", "C order", "pins",
                                  "markov-3", "one slice", "permissible"])
def test_labels_window_matches_decode_window(name):
  """decode_window_labels_device's labels are decode_window's volume on
  the device, its cc decode_window_device's, and its vcg the VCG
  window's."""
  vol, binary = streams(name)
  head = crackle.header(binary)
  sz = head.sz
  labels, cc, vcg = ct.decode_window_labels_device(binary, 1 % sz, sz,
                                                   device="cpu")
  want = ct.decode_window_device(binary, 1 % sz, sz, device="cpu")
  np.testing.assert_array_equal(labels.numpy(), want[0].numpy())
  np.testing.assert_array_equal(cc.numpy(), want[1].numpy())
  np.testing.assert_array_equal(
    vcg.numpy(), ct.decode_window_vcg_device(binary, 1 % sz, sz,
                                             device="cpu").numpy())
  host = np.asarray(vol[:, :, 1 % sz:]).transpose(2, 1, 0).reshape(
    sz - 1 % sz, -1)
  np.testing.assert_array_equal(labels.numpy().astype(host.dtype), host)
