"""The port's host arrays (crackle_tpu_torch/array.py: CrackleArray,
CrackleRemoteArray), codec.compressa, zstack of CrackleArrays and the
package's exports, against crackle_tpu's, on seeded numpy volumes.

The port runs under set_engine('numpy') (its host engine) and under
set_engine('torch', device="cpu") (the device routes on the kernels'
plain versions); the reference on its host engine.
"""
import ast
import inspect
import os

import numpy as np
import pytest

import crackle_tpu as crackle
from crackle_tpu import operations as rops
import crackle_tpu_torch as ct
from crackle_tpu_torch import array as tarr
from crackle_tpu_torch import codec as pcodec
from crackle_tpu_torch.ops import analytics as tana

from test_codec import random_volume
from test_torch_pins import pins_volume


def _signed():
  """A signed stream (compress takes no signed labels): labels -16..-13
  written as their uint32 bits, the header's signed flag then set."""
  from crackle_tpu.headers import CrackleHeader
  vol = random_volume((16, 16, 5), 4, seed=52, smooth=6)
  binary = crackle.compress(np.asfortranarray(vol + np.uint32(2 ** 32 - 16)))
  head = CrackleHeader.frombytes(binary)
  head.signed = True
  hb = head.tobytes()
  binary = hb + binary[len(hb):]
  np.testing.assert_array_equal(crackle.decompress(binary),
                                vol.astype(np.int32) - 16)
  return binary


# name -> its crackle_tpu stream; every shape takes the stats kernel
# (sy a multiple of 8, sx >= 8) except the pins and C-order ones
STREAMS = {
  "flat": lambda: crackle.compress(
    random_volume((16, 16, 6), 4, seed=51, smooth=6)),
  "pins": lambda: crackle.compress(pins_volume(), allow_pins=1),
  "u64": lambda: crackle.compress(np.asfortranarray(
    random_volume((16, 8, 5), 4, seed=53, smooth=5).astype(np.uint64)
    + np.uint64(2) ** 40)),
  "signed": _signed,
  "C order": lambda: crackle.compress(np.ascontiguousarray(
    random_volume((13, 11, 5), 4, seed=54, smooth=5))),
  "markov-5": lambda: crackle.compress(
    random_volume((16, 16, 5), 5, seed=55, smooth=6), markov_model_order=5),
}


def stream(name):
  binary = STREAMS[name]()
  assert (crackle.header(binary).label_format == 2) == (name == "pins")
  return binary


@pytest.fixture(params=["numpy", "torch"])
def engine(request, monkeypatch):
  """The port's codec on its host engine, or on the torch engine on the
  CPU; the reference on its host engine."""
  from crackle_tpu import codec as rcodec
  monkeypatch.setattr(rcodec, "_ENGINE", "numpy")
  if request.param == "numpy":
    pcodec.set_engine("numpy")
  else:
    pcodec.set_engine("torch", device="cpu")
  yield request.param
  pcodec.set_engine("auto")


def engine_declines(caplog):
  """The torch engine's declines logged so far (a decline sends the
  window to the host codec)."""
  return [r.getMessage() for r in caplog.records
          if r.name == "crackle_tpu_torch.engine"]


def assert_same(got, want, path="result"):
  """got (the port's) equals want (the reference's): CrackleArrays by
  their bytes, numpy arrays by dtype, shape and values, floats within
  rtol 1e-12, containers entry by entry."""
  if isinstance(want, crackle.CrackleArray):
    assert isinstance(got, ct.CrackleArray), path
    assert got.binary == want.binary, path
    assert got.parallel == want.parallel, path
  elif isinstance(want, np.ndarray):
    assert isinstance(got, np.ndarray), path
    assert got.dtype == want.dtype and got.shape == want.shape, path
    if want.dtype.kind == "f":
      np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=path)
    else:
      np.testing.assert_array_equal(got, want, err_msg=path)
  elif isinstance(want, dict):
    # the same keys, in any order: the device routes list labels sorted,
    # the host loops as they come
    assert isinstance(got, dict) and len(got) == len(want), path
    assert set(got) == set(want), path
    for k in want:
      assert_same(got[k], want[k], f"{path}[{k!r}]")
  elif isinstance(want, (tuple, list)):
    assert type(got) is type(want) and len(got) == len(want), path
    for i, (g, w) in enumerate(zip(got, want)):
      assert_same(g, w, f"{path}[{i}]")
  elif isinstance(want, float):
    assert got == pytest.approx(want, rel=1e-12), path
  else:
    assert type(got) is type(want), path
    assert got == want, path


def same_outcome(fn_ref, fn_port):
  """Both calls give the same result (assert_same) or raise exceptions
  of the same type (by name: each package has its own FormatError)."""
  try:
    want = fn_ref()
  except Exception as exc:  # the reference's error is the expectation
    with pytest.raises(Exception) as got:
      fn_port()
    assert type(got.value).__name__ == type(exc).__name__
    return None
  got = fn_port()
  assert_same(got, want)
  return got


def arrays(name):
  binary = stream(name)
  return ct.CrackleArray(binary), crackle.CrackleArray(binary)


# index expressions of __getitem__
INDEXES = {
  "all": np.s_[:, :, :],
  "box": np.s_[2:9, 1:5, 1:4],
  "x int": np.s_[5],
  "y int": np.s_[:, 3],
  "z int": np.s_[:, :, 2],
  "z numpy int": np.s_[:, :, np.int64(4)],
  "ellipsis z": np.s_[..., 3],
  "ellipsis": np.s_[...],
  "z step": np.s_[:, :, ::2],
  "z start step": np.s_[:, :, 1:5:3],
  "negatives": np.s_[-3:, :, -1],
  "xy steps": np.s_[::3, 1::2, 1:3],
  "one slice range": np.s_[0:4, 0:4, 4:5],
}


@pytest.mark.parametrize("index", list(INDEXES))
@pytest.mark.parametrize("name", list(STREAMS))
def test_getitem_matches_reference(engine, caplog, name, index):
  a, r = arrays(name)
  key = INDEXES[index]
  same_outcome(lambda: r[key], lambda: a[key])
  assert not engine_declines(caplog)


@pytest.mark.parametrize("name", ["flat", "pins"])
def test_getitem_newaxis_matches_reference(engine, name):
  """[..., np.newaxis] returns the array itself with a trailing axis,
  which every later cutout carries."""
  a, r = arrays(name)
  assert a[..., np.newaxis] is a and r[..., np.newaxis] is r
  assert a.shape == r.shape and a.ndim == r.ndim == 4
  for key in (np.s_[:, :, 1:3], np.s_[2:5, 3, 0]):
    assert_same(a[key], r[key])


def _setitem_cases(shape):
  """(index, data maker) pairs of __setitem__; data from the stream's
  own labels (so the crack formats can stay alike) or a scalar."""
  sx, sy, sz = shape
  return {
    "z range, int": (np.s_[:, :, 1:3], lambda v: 0),
    "z range, array": (np.s_[:, :, 1:3], lambda v: v[:, :, 3:5]),
    "partial xy, array": (np.s_[2:7, 1:6, 2:4], lambda v: v[2:7, 1:6, 0:2]),
    "partial xy, int": (np.s_[2:7, 1:6, 2:4], lambda v: 1),
    "to the end, array": (np.s_[:, :, 3:], lambda v: v[:, :, 0:sz - 3]),
    "first slice, int": (np.s_[:, :, 0], lambda v: 2),
    "whole, array": (np.s_[:, :, :], lambda v: v[::-1, :, :]),
    "whole, float": (np.s_[:, :, :], lambda v: 3.0),
    "wrong depth": (np.s_[:, :, 1:3], lambda v: v[:, :, 0:1]),
  }


@pytest.mark.parametrize("case", list(_setitem_cases((1, 1, 5))))
@pytest.mark.parametrize("name", ["flat", "pins", "u64", "C order",
                                  "markov-5"])
def test_setitem_matches_reference(engine, caplog, name, case):
  """The stream after the write: the reference's bytes, or the same
  exception (zstack of unlike crack formats, a depth mismatch)."""
  a, r = arrays(name)
  vol = crackle.decompress(r.binary)
  key, make = _setitem_cases(r.shape)[case]
  data = make(vol)

  def write(arr):
    arr[key] = data.copy() if isinstance(data, np.ndarray) else data
    return arr

  same_outcome(lambda: write(r), lambda: write(a))
  assert not engine_declines(caplog)


def test_setitem_of_a_signed_stream_matches_reference(engine):
  """compress takes no signed labels: both raise the same error."""
  a, r = arrays("signed")
  for key, data in ((np.s_[:, :, 1:3], 0), (np.s_[1:4, 2:5, 0:2], -1)):
    same_outcome(lambda: r.__setitem__(key, data),
                 lambda: a.__setitem__(key, data))


def _methods(tmp_path):
  """name -> (call on an array, as each package's array takes it)."""
  def meta(arr):
    # the parquet sidecar read back as a dict of columns
    import pyarrow.parquet as pq
    path = os.path.join(tmp_path, f"{type(arr).__module__}.meta")
    arr.cache_meta(path)
    return pq.read_table(path).to_pydict()

  def saved(arr):
    path = os.path.join(tmp_path, f"{type(arr).__module__}.ckl")
    arr.save(path)
    with open(path, "rb") as f:
      return f.read()

  def first(arr):
    return int(arr.labels()[0])

  def last(arr):
    return int(arr.labels()[-1])

  return {
    "len": len,
    "header": lambda a: a.header().tobytes(),
    "random_access": lambda a: a.random_access,
    "size": lambda a: a.size,
    "ndim": lambda a: a.ndim,
    "nbytes": lambda a: a.nbytes,
    "copy": lambda a: a.copy(),
    "dtype": lambda a: a.dtype,
    "labels": lambda a: a.labels(),
    "labels z int": lambda a: a.labels(2),
    "labels z slice": lambda a: a.labels(slice(1, 4)),
    "num_labels": lambda a: a.num_labels(),
    "voxel_counts": lambda a: a.voxel_counts(),
    "voxel_counts label": lambda a: a.voxel_counts(label=first(a)),
    "centroids": lambda a: a.centroids(),
    "centroids label": lambda a: a.centroids(label=last(a)),
    "bounding_boxes": lambda a: a.bounding_boxes(),
    "bounding_boxes raw": lambda a: a.bounding_boxes(
      no_slice_conversion=True),
    "bounding_boxes label": lambda a: a.bounding_boxes(label=first(a)),
    "min": lambda a: a.min(),
    "max": lambda a: a.max(),
    "remap": lambda a: a.remap({first(a): last(a) + 5},
                               preserve_missing_labels=True),
    "remap strict": lambda a: a.remap({first(a): 1}),
    "refit": lambda a: a.refit(),
    "astype": lambda a: a.astype(np.uint16),
    "renumber": lambda a: a.renumber(start=1),
    "numpy": lambda a: a.numpy(),
    "decompress label": lambda a: a.decompress(label=last(a)),
    "decompress label crop": lambda a: a.decompress(label=last(a),
                                                    crop=True),
    "condense": lambda a: a.condense(),
    "point_cloud": lambda a: a.point_cloud(),
    "point_cloud label": lambda a: a.point_cloud(
      label=first(a), skip_background=False, z_start=1, z_end=3),
    "connected_components": lambda a: a.connected_components(6),
    "connected_components mapping": lambda a: a.connected_components(
      26, return_mapping=True),
    "mode_pooling_2x2x1": lambda a: a.mode_pooling_2x2x1(),
    "voxel_connectivity_graph": lambda a: a.voxel_connectivity_graph(),
    "voxel_connectivity_graph 6": lambda a: a.voxel_connectivity_graph(6),
    "contacts": lambda a: a.contacts((1.0, 2.0, 3.0)),
    "cache_meta": meta,
    "save": saved,
    "each": lambda a: list(a.each()),
    "each labels multi": lambda a: list(a.each(
      crop=False, labels=[first(a), last(a)], multi=True)),
    "mask": lambda a: a.mask([first(a)]),
    "mask_except": lambda a: a.mask_except([first(a)], value=1),
    "array_equal self": lambda a: a.array_equal(a.copy()),
    "array_equal masked": lambda a: a.array_equal(a.mask([first(a)])),
    "contains_range": lambda a: a.contains_range(first(a), last(a)),
    "== int": lambda a: a == first(a),
    "== array": lambda a: a == a.copy(),
    "== other": lambda a: a == "x",
    "+": lambda a: a + 3,
    "radd": lambda a: 3 + a,
    "-": lambda a: (a + 4) - 1,
    "rsub": lambda a: 1 - (a + 4),
    "*": lambda a: a * 2,
    "rmul": lambda a: 2 * a,
    "//": lambda a: a // 2,
    "rfloordiv": lambda a: 2 // a,
    "in": lambda a: (first(a) in a, (last(a) + 1) in a),
  }


METHODS = list(_methods("."))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", ["flat", "pins", "u64", "signed",
                                  "markov-5"])
def test_methods_match_reference(engine, tmp_path, name, method):
  """Every method, property and operator of CrackleArray: the same value
  (CrackleArrays by their bytes) or the same exception."""
  a, r = arrays(name)
  fn = _methods(str(tmp_path))[method]
  same_outcome(lambda: fn(r), lambda: fn(a))


def test_codec_analytics_is_the_ports():
  assert tarr.codec_analytics() is tana
  assert "crackle_tpu_torch" in tarr.codec_analytics().__name__


@pytest.mark.parametrize("fn", ["voxel_counts", "centroids",
                                "bounding_boxes"])
def test_statistics_run_on_the_engines_device(engine, monkeypatch, fn):
  """The array's statistics pass the codec engine's device (the CPU
  under set_engine('torch', device="cpu"), None, the host loop, under
  'numpy'), not the analytics functions' default "cuda"."""
  seen = []
  real = tana._device_label_stats

  def spy(binary, device, *args):
    seen.append(device)
    return real(binary, device, *args)

  monkeypatch.setattr(tana, "_device_label_stats", spy)
  a, r = arrays("flat")
  assert_same(getattr(a, fn)(), getattr(r, fn)())
  assert seen == (["cpu"] if engine == "torch" else [None])


def test_device_array_decline_names_crackle_array(monkeypatch):
  monkeypatch.setattr(tarr._engine, "upload_stream", lambda *a: None)
  with pytest.raises(ValueError, match="CrackleArray"):
    ct.CrackleDeviceArray(stream("flat"), "cpu")


# ---------------------------------------------------------------------------
# CrackleRemoteArray: a file path (_LocalRangeReader) and a bytes-like
# reader, against the reference's remote array over the same stream
# ---------------------------------------------------------------------------

class RangeReader:
  """A duck-typed remote file: bytes by slice, each read counted."""

  def __init__(self, binary):
    self.binary = binary
    self.reads = []

  def __getitem__(self, slc):
    self.reads.append(slc)
    return self.binary[slc]


def remotes(name, tmp_path, how):
  binary = stream(name)
  if how == "path":
    path = str(tmp_path / f"{name}.ckl")
    with open(path, "wb") as f:
      f.write(binary)
    return ct.CrackleRemoteArray(path), crackle.CrackleRemoteArray(path)
  if how == "bytes":
    return ct.CrackleRemoteArray(binary), crackle.CrackleRemoteArray(binary)
  return (ct.CrackleRemoteArray(RangeReader(binary)),
          crackle.CrackleRemoteArray(RangeReader(binary)))


@pytest.mark.parametrize("how", ["path", "bytes", "reader"])
@pytest.mark.parametrize("name", list(STREAMS))
def test_remote_array_matches_reference(engine, caplog, tmp_path, name,
                                        how):
  a, r = remotes(name, tmp_path, how)
  assert a.shape == r.shape
  assert a.header.tobytes() == r.header.tobytes()
  for z in range(r.shape[2]):
    got = a[z]
    assert_same(got, r[z], f"z={z}")
    np.testing.assert_array_equal(
      got, crackle.decompress(stream(name))[:, :, z])
  assert_same(a.labels(), r.labels())
  assert a.num_labels() == r.num_labels()
  for label in list(r.labels()[:2]) + [int(r.labels()[-1]) + 1]:
    assert (label in a) == (label in r)
  assert_same(a.fetch_crc_trailer(), r.fetch_crc_trailer())
  assert not engine_declines(caplog)


def test_remote_array_reads_only_ranges(engine, tmp_path):
  """A slice read takes the header, the index, labels and model once,
  the CRC trailer once and then only that slice's crack bytes."""
  a, _ = remotes("flat", tmp_path, "reader")
  a[2]
  n = len(a.cf.reads)
  a[3]
  assert len(a.cf.reads) == n + 1
  z0, z1 = int(a.z_index[3]), int(a.z_index[4])
  assert a.cf.reads[-1] == slice(z0, z1)


def test_remote_array_header_crc(engine):
  binary = bytearray(stream("flat"))
  binary[10] ^= 0xFF
  for cls in (ct.CrackleRemoteArray, crackle.CrackleRemoteArray):
    with pytest.raises(Exception, match="CRC"):
      cls(bytes(binary))
  a = ct.CrackleRemoteArray(bytes(binary), ignore_header_crc_check=True)
  r = crackle.CrackleRemoteArray(bytes(binary), ignore_header_crc_check=True)
  assert a.shape == r.shape


def test_local_range_reader_matches_reference(tmp_path):
  path = str(tmp_path / "x.bin")
  with open(path, "wb") as f:
    f.write(bytes(range(200)))
  a, r = tarr._LocalRangeReader(path), crackle.array._LocalRangeReader(path)
  for slc in (np.s_[:29], np.s_[5:40], np.s_[-12:], np.s_[150:], np.s_[0:0],
              np.s_[190:400]):
    assert a[slc] == r[slc]


# ---------------------------------------------------------------------------
# compressa, zstack of CrackleArrays, the package's exports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [{}, {"allow_pins": 1}, {"parallel": 2},
                                    {"markov_model_order": 3}])
def test_compressa_matches_reference(engine, kwargs):
  vol = pins_volume()
  assert_same(ct.compressa(vol, **kwargs), crackle.compressa(vol, **kwargs))
  assert ct.compressa is pcodec.compressa


@pytest.mark.parametrize("name", ["flat", "pins", "markov-5", "C order"])
def test_zstack_of_crackle_arrays_matches_reference(engine, name):
  """CrackleArrays, alone and mixed with bytes, None and numpy: the
  reference's bytes or its exception."""
  binary = stream(name)
  if name == "pins":  # zsplit takes no pins stream
    rest = crackle.compress(pins_volume()[:, :, 3:], allow_pins=1)
    first = crackle.compress(pins_volume()[:, :, :3], allow_pins=1)
  else:
    _, first, rest = rops.zsplit(binary, 1)
  for parts in ([binary, binary], [rest, first, binary]):
    same_outcome(
      lambda: rops.zstack([crackle.CrackleArray(p) for p in parts]),
      lambda: ct.zstack([ct.CrackleArray(p) for p in parts]))
    vol = crackle.decompress(parts[-1])
    same_outcome(
      lambda: rops.zstack([crackle.CrackleArray(parts[0]), None, vol]),
      lambda: ct.zstack([ct.CrackleArray(parts[0]), None, vol]))


def _reference_exports():
  """The names crackle_tpu/__init__.py imports, and __version__."""
  tree = ast.parse(inspect.getsource(crackle))
  names = [a.asname or a.name for node in tree.body
           if isinstance(node, ast.ImportFrom) for a in node.names]
  return names + ["__version__"]


def test_all_covers_the_reference_exports():
  names = _reference_exports()
  assert len(names) > 60
  missing = [n for n in names if n not in ct.__all__]
  assert not missing
  for n in ct.__all__:
    assert hasattr(ct, n), n
  assert len(set(ct.__all__)) == len(ct.__all__)
  assert ct.__version__ == crackle.__version__
  assert ct.CrackleHeader is ct.headers.CrackleHeader
  assert ct.FormatError is ct.headers.FormatError


@pytest.mark.parametrize("name", ["CrackleArray", "CrackleRemoteArray",
                                  "compressa", "save", "load", "aload",
                                  "bload", "rload", "save_numpy"])
def test_exports_keep_the_reference_signatures(name):
  """The same parameters, kinds and defaults (the annotations name each
  package's own classes)."""
  def params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]
  assert params(getattr(ct, name)) == params(getattr(crackle, name))
