"""The port's own host layer (crackle_tpu_torch.codec, headers, lib, ops,
models, native) against the reference's, from which it was copied: the
same bytes out of compress, the same volumes out of decompress, the
same parsed sections, on the golden fixtures and on random volumes."""
import os
import sys

import numpy as np
import pytest
import torch

import crackle_tpu as crackle
from crackle_tpu import codec as rcodec
from crackle_tpu.lib import ctoi
from crackle_tpu.models import markov as rmarkov
from crackle_tpu.ops import crackcode as rcc
from crackle_tpu.ops import labels as rlabels
import crackle_tpu_torch as ct
from crackle_tpu_torch import codec as pcodec
from crackle_tpu_torch import lib as plib
from crackle_tpu_torch import native as pnative
from crackle_tpu_torch.models import markov as pmarkov
from crackle_tpu_torch.ops import crackcode as pcc
from crackle_tpu_torch.ops import labels as plabels

from test_torch_pins import pins_volume

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "golden"))
from volumes import CASES as GOLDEN, make_volume  # noqa: E402

FIXDIR = os.path.join(HERE, "golden", "fixtures")


@pytest.fixture
def numpy_engine(monkeypatch):
  """The reference decodes on its host engine, as the port's copy does."""
  monkeypatch.setattr(rcodec, "_ENGINE", "numpy")


def _fixture(name):
  with open(os.path.join(FIXDIR, name + ".ckl"), "rb") as f:
    return f.read()


def check_sections(binary):
  """Header, BOC indexes, label sections and markov decodes of one
  stream, parsed by both packages."""
  rh, ph = rcodec.header(binary), pcodec.header(binary)
  assert ph.tobytes() == rh.tobytes()
  for attr in ("sx", "sy", "sz", "data_width", "stored_data_width",
               "label_format", "crack_format", "markov_model_order",
               "num_label_bytes", "fortran_order", "is_sorted"):
    assert getattr(ph, attr) == getattr(rh, attr), attr
  assert pcodec.num_labels(binary) == rcodec.num_labels(binary)
  np.testing.assert_array_equal(pcodec.labels(binary), rcodec.labels(binary))
  crcs = rcodec.crack_crcs(binary)
  if crcs is not None:
    np.testing.assert_array_equal(pcodec.crack_crcs(binary), crcs)
  codes = rcodec.crack_codes(binary)
  assert pcodec.crack_codes(binary) == codes
  rmodel = rcodec.decode_markov_model(rh, binary)
  pmodel = pcodec.decode_markov_model(ph, binary)
  if rmodel is None:
    assert pmodel is None
  else:
    np.testing.assert_array_equal(pmodel, rmodel)
  for code in codes:
    if not code:
      continue
    np.testing.assert_array_equal(pcc.read_boc_index(code, ph.sx, ph.sy),
                                  rcc.read_boc_index(code, rh.sx, rh.sy))
    if rmodel is not None:
      body = code[4 + ctoi(code, 0, 4):]
      np.testing.assert_array_equal(
        pmarkov.decode_markov(body, pmodel, ph.markov_model_order),
        rmarkov.decode_markov(body, rmodel, rh.markov_model_order))
  if rh.voxels() == 0:
    return
  lb = bytes(rcodec.raw_labels(binary))
  assert plabels.decode_num_labels(ph, lb) == rlabels.decode_num_labels(rh,
                                                                        lb)
  np.testing.assert_array_equal(plabels.decode_uniq(ph, lb),
                                rlabels.decode_uniq(rh, lb))
  np.testing.assert_array_equal(plabels.components_per_grid(ph, lb),
                                rlabels.components_per_grid(rh, lb))
  if rh.label_format == 0:
    np.testing.assert_array_equal(
      plabels.decode_flat(ph, lb, 0, rh.sz, rh.dtype),
      rlabels.decode_flat(rh, lb, 0, rh.sz, rh.dtype))
  else:
    for got, want in zip(plabels.decode_condensed_pins(ph, lb),
                         rlabels.decode_condensed_pins(rh, lb)):
      assert sorted(got) == sorted(want)
      for label in want:
        np.testing.assert_array_equal(np.asarray(got[label]),
                                      np.asarray(want[label]))


@pytest.mark.parametrize("name,spec,opts", GOLDEN,
                         ids=[c[0] for c in GOLDEN])
def test_golden_fixtures(numpy_engine, name, spec, opts):
  vol = make_volume(spec)
  binary = _fixture(name)
  assert pcodec.compress(vol, **opts) == binary
  want = crackle.decompress(binary)
  got = pcodec.decompress(binary)
  assert got.dtype == want.dtype and got.flags.f_contiguous == \
    want.flags.f_contiguous
  np.testing.assert_array_equal(got, want)
  check_sections(binary)


def _volume(dtype, permissible, seed):
  """Noisy labels give a permissible crack format, blocky ones (most
  neighbour pairs equal) an impermissible one; offsets fill the width."""
  rng = np.random.RandomState(seed)
  if permissible:
    vol = rng.randint(0, 5, (24, 20, 6))
  else:
    vol = np.repeat(np.repeat(rng.randint(0, 7, (6, 5, 6)), 4, 0), 4, 1)
  top = np.iinfo(dtype).max
  vol = vol.astype(np.uint64) * np.uint64(top // 8) + np.uint64(1)
  return np.asfortranarray(vol.astype(dtype))


@pytest.mark.parametrize("pins", [0, 1], ids=["flat", "pins"])
@pytest.mark.parametrize("order", [0, 5])
@pytest.mark.parametrize("permissible", [True, False],
                         ids=["permissible", "impermissible"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32,
                                   np.uint64])
def test_random_volumes(numpy_engine, dtype, permissible, order, pins):
  vol = _volume(dtype, permissible, 11 * order + pins)
  opts = dict(allow_pins=pins, markov_model_order=order)
  binary = crackle.compress(vol, **opts)
  assert (crackle.header(binary).crack_format == 1) == permissible
  assert pcodec.compress(vol, **opts) == binary
  got = pcodec.decompress(binary)
  np.testing.assert_array_equal(got, crackle.decompress(binary))
  np.testing.assert_array_equal(got, vol)
  check_sections(binary)


def test_queries_match(numpy_engine):
  vol = pins_volume()
  for binary in (crackle.compress(vol), crackle.compress(vol,
                                                         allow_pins=1)):
    for label in [0, 1, 2, 3, 9]:
      assert pcodec.contains(binary, label) == rcodec.contains(binary, label)
      if rcodec.contains(binary, label):
        assert pcodec.z_range_for_label(binary, label) == \
          rcodec.z_range_for_label(binary, label)
    for z0, z1 in [(0, 10), (3, 7)]:
      np.testing.assert_array_equal(
        pcodec.decompress_range(binary, z0, z1),
        rcodec.decompress_range(binary, z0, z1))
    np.testing.assert_array_equal(pcodec.decompress(binary, label=2),
                                  rcodec.decompress(binary, label=2))


def test_crc32c_without_google_crc32c(monkeypatch):
  """Where google_crc32c is not installed, lib.crc32c takes the native
  library's CRC, which equals the table loop."""
  rng = np.random.RandomState(1)
  data = rng.randint(0, 256, 100_003).astype(np.uint8)
  want = plib.crc32c(data)
  assert want == rcodec.crc32c(data)
  if not pnative.available():
    pytest.skip("no C++ compiler for the native library")
  monkeypatch.setattr(plib, "_HAS_GOOGLE_CRC", False)
  assert plib.crc32c(data) == want
  assert plib.crc32c(data[:1000]) == plib._crc32c_py(data[:1000].tobytes())
  assert plib.crc32c(b"") == 0


# the CrackleDeviceArray cutouts of chip_smoke.py, cut to these volumes,
# where the smoke's oracle indexes the decoded volume with numpy
CUTOUT_KEYS = [np.s_[10:30, 5:35, 2:8], np.s_[:, :, 5], np.s_[7],
               np.s_[3:20, 0:20, 1:9], np.s_[0:32, 10:11, 3:9]]


def test_native_load_from_many_threads(monkeypatch, tmp_path):
  """Threads that call native.load() while another builds the library
  wait for it and get the library, not None: the device encode's trace
  pool can be the first user of a fresh checkout."""
  import time
  from concurrent.futures import ThreadPoolExecutor
  assert pnative.load() is not None
  src = tmp_path / "newer.cpp"
  src.write_text("")
  later = time.time() + 1000
  os.utime(src, (later, later))

  def slow_build():
    time.sleep(0.3)
    return True

  monkeypatch.setattr(pnative, "_SRC", str(src))
  monkeypatch.setattr(pnative, "_build", slow_build)
  monkeypatch.setattr(pnative, "_lib", None)
  monkeypatch.setattr(pnative, "_tried", False)
  with ThreadPoolExecutor(8) as pool:
    libs = list(pool.map(lambda _: pnative.load(), range(8)))
  assert all(lib is not None for lib in libs)


@pytest.mark.parametrize("pins", [0, 1], ids=["flat", "pins"])
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_device_array_matches_crackle_array(dtype, pins):
  vol = np.asfortranarray(np.tile(pins_volume(), (2, 2, 1)).astype(dtype))
  if dtype == np.uint64 and not pins:
    vol = vol + np.uint64(1 << 40)
  binary = crackle.compress(vol, allow_pins=pins)
  assert crackle.header(binary).label_format == 2 * pins
  arr = ct.CrackleDeviceArray(binary, "cpu")
  ref = crackle.CrackleArray(binary)
  for key in CUTOUT_KEYS + [np.s_[..., 5]]:
    got = arr[key]
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want = ref[key]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().astype(want.dtype), want)
    if key in CUTOUT_KEYS:  # the smoke's oracle
      np.testing.assert_array_equal(vol[key], want)
