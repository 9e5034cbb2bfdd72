"""The port's file I/O (crackle_tpu_torch/util.py) against
crackle_tpu.util, and its profiling helpers
(crackle_tpu_torch/utils/profiling.py) on the CPU.

The port runs under set_engine('numpy') and under set_engine('torch',
device="cpu"); the reference on its host engine.
"""
import glob
import gzip
import io
import json
import lzma
import os

import numpy as np
import pytest
import torch

import crackle_tpu as crackle
from crackle_tpu import util as rutil
import crackle_tpu_torch as ct
from crackle_tpu_torch import util as tutil
from crackle_tpu_torch.utils import profiling

from test_torch_array import assert_same, engine, same_outcome, stream  # noqa: F401

_OPEN = {".gz": gzip.open, ".xz": lzma.open, ".lzma": lzma.open}


def payload(path):
  """A file's bytes, through its compression suffix (gzip stamps the
  time into its header, so two .gz files of one payload differ)."""
  opener = _OPEN.get(os.path.splitext(path)[1], open)
  with opener(path, "rb") as f:
    return f.read()


def both(tmp_path, name):
  """The same file name in the reference's and the port's directory."""
  for sub in ("ref", "port"):
    os.makedirs(tmp_path / sub, exist_ok=True)
  return str(tmp_path / "ref" / name), str(tmp_path / "port" / name)


SAVE_EXTS = [".ckl", ".ckl.gz", ".ckl.xz", ".ckl.lzma", ".npy", ".npy.gz"]


@pytest.mark.parametrize("ext", SAVE_EXTS)
@pytest.mark.parametrize("kind", ["numpy", "CrackleArray"])
@pytest.mark.parametrize("name", ["flat", "pins", "u64", "C order",
                                  "markov-5"])
def test_save_matches_reference(engine, tmp_path, name, kind, ext):
  """save() writes the reference's payload; load, aload, bload and rload
  read it back as the reference's do."""
  binary = stream(name)
  vol = crackle.decompress(binary)
  ref, port = both(tmp_path, "vol" + ext)
  if kind == "numpy":
    rutil.save(vol, ref)
    ct.save(vol, port)
  else:
    rutil.save(crackle.CrackleArray(binary), ref)
    ct.save(ct.CrackleArray(binary), port)
  # np.save adds .npy to a name that does not end in it, in both
  (ref,) = glob.glob(ref + "*")
  (port,) = glob.glob(port + "*")
  assert payload(port) == payload(ref)
  if ext.startswith(".ckl"):
    if kind == "CrackleArray":
      assert payload(port) == binary
    assert_same(ct.load(port), rutil.load(ref))
    np.testing.assert_array_equal(ct.load(port), vol)
    assert ct.bload(port) == rutil.bload(ref)
    assert ct.aload(port).binary == rutil.aload(ref).binary
    if ext == ".ckl":
      remote = ct.rload(port)
      assert isinstance(remote, ct.CrackleRemoteArray)
      for z in (0, vol.shape[2] - 1):
        np.testing.assert_array_equal(remote[z], vol[:, :, z])
  # (a .ckl loads as a CrackleArray, which numpy cannot take whole)
  same_outcome(lambda: rutil.load_any(ref), lambda: tutil.load_any(port))


@pytest.mark.parametrize("name", ["flat", "pins", "markov-5"])
def test_load_with_mmap_and_labels_match_reference(engine, tmp_path, name):
  binary = stream(name)
  ref, port = both(tmp_path, "vol.ckl")
  for path in (ref, port):
    with open(path, "wb") as f:
      f.write(binary)
  a = ct.aload(port, allow_mmap=True)
  r = rutil.aload(ref, allow_mmap=True)
  assert a.shape == r.shape
  for key in (np.s_[:, :, :], np.s_[1:5, 2:6, 1:3], np.s_[:, :, 2]):
    assert_same(a[key], r[key])
  assert bytes(ct.bload(port, allow_mmap=True)) == binary
  label = int(crackle.labels(binary)[-1])
  assert_same(ct.load(port, label=label), rutil.load(ref, label=label))
  assert tutil.load_num_labels(port) == rutil.load_num_labels(ref)
  assert tutil.load_header(port).tobytes() == \
    rutil.load_header(ref).tobytes()


def test_file_objects_match_reference(engine):
  """save to and load from open file objects, and the prefix readers."""
  binary = stream("flat")
  vol = crackle.decompress(binary)
  got, want = io.BytesIO(), io.BytesIO()
  ct.save(vol, got)
  rutil.save(vol, want)
  assert got.getvalue() == want.getvalue() == binary
  for reader in ("load", "bload", "load_num_labels", "load_header"):
    a = getattr(tutil, reader)(io.BytesIO(binary))
    r = getattr(rutil, reader)(io.BytesIO(binary))
    if reader == "load_header":
      a, r = a.tobytes(), r.tobytes()
    assert_same(a, r)
  assert_same(tutil.load_numpy(io.BytesIO(_npy(vol))),
              rutil.load_numpy(io.BytesIO(_npy(vol))))


def _npy(vol):
  f = io.BytesIO()
  np.save(f, vol)
  return f.getvalue()


@pytest.mark.parametrize("block_size", [1, 300, int(200e6)])
@pytest.mark.parametrize("name", ["flat", "u64", "C order", "pins"])
def test_save_numpy_matches_reference(engine, tmp_path, name, block_size):
  """save_numpy of bytes, a CrackleArray and an array, in z blocks of at
  most block_size bytes: the reference's file, loading as the volume.

  The reference's fault is kept for equal bytes: a C-order stream in
  more than one block is written block after block, which is not C
  order, so its file does not load as the volume."""
  binary = stream(name)
  vol = crackle.decompress(binary)
  head = crackle.header(binary)
  blocks = -(-head.sz // max(min(block_size // (head.nbytes // head.sz),
                                 head.sz), 1))
  for i, (a, r) in enumerate(((binary, binary),
                              (ct.CrackleArray(binary),
                               crackle.CrackleArray(binary)),
                              (vol, vol))):
    ref, port = both(tmp_path, f"v{i}.npy")
    rutil.save_numpy(r, ref, block_size=block_size)
    ct.save_numpy(a, port, block_size=block_size)
    assert payload(port) == payload(ref)
    if head.fortran_order or blocks == 1 or i == 2:
      assert_same(np.load(port), vol)
    else:
      assert not np.array_equal(np.load(port), vol)


@pytest.mark.parametrize("filename", [
  "x.ckl", "x.ckl.gz", "x.ckl.xz.gz", "x.npy", "x.npy.gz", "x.nii.gz",
  "x.tar.gz", "x", "x.cpso.xz", "x.tif"])
def test_normalize_file_ext_matches_reference(filename):
  assert tutil.normalize_file_ext(filename) == \
    rutil.normalize_file_ext(filename)


@pytest.mark.parametrize("fn, ext", [
  ("load_any", ".bad"), ("load_any", ".nrrd"), ("load_any", ".nii"),
  ("load_any", ".tif"), ("load_any", ".cpso"), ("save_nii", ".nii"),
  ("save_nrrd", ".nrrd"), ("save_tiff", ".tiff"),
  ("save_compresso", ".cpso")])
def test_converters_without_their_packages_match_reference(tmp_path, fn, ext):
  """The formats whose packages are missing raise what the reference
  raises (ImportError at use), an unknown extension ValueError."""
  vol = crackle.decompress(stream("flat"))
  ref, port = both(tmp_path, "x" + ext)
  if fn == "load_any":
    for path in (ref, port):
      with open(path, "wb") as f:
        f.write(b"\0" * 64)
    same_outcome(lambda: rutil.load_any(ref), lambda: tutil.load_any(port))
  else:
    same_outcome(lambda: getattr(rutil, fn)(vol, ref),
                 lambda: getattr(tutil, fn)(vol, port))


# ---------------------------------------------------------------------------
# utils.profiling on the CPU: trace() without CUDA activity, timer() with a
# CPU tensor and a device, annotate()
# ---------------------------------------------------------------------------

def _trace_names(log_dir):
  (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
  with open(path) as f:
    return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_exports_a_chrome_trace_with_spans(engine, tmp_path):
  """A cutout of a CrackleArray inside trace(): the exported trace holds
  the annotate span and the torch operations the engine ran."""
  arr = ct.CrackleArray(stream("flat"))
  cut = profiling.annotate("crackle cutout")(lambda: arr[:, :, 1:4])
  log_dir = str(tmp_path / "trace")
  with profiling.trace(log_dir) as d:
    got = cut()
  assert d == log_dir
  np.testing.assert_array_equal(got, crackle.decompress(arr.binary)[:, :, 1:4])
  names = _trace_names(log_dir)
  assert "crackle cutout" in names
  if engine == "torch":
    assert any(n and n.startswith("aten::") for n in names)


def test_trace_writes_under_the_temp_directory(tmp_path, monkeypatch):
  """With no log_dir the trace goes to a directory under the system's
  temp directory (TMPDIR), and an exception still writes it."""
  import tempfile
  monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
  with pytest.raises(RuntimeError):
    with profiling.trace() as d:
      torch.ones(3).sum()
      raise RuntimeError("inside the block")
  assert d.startswith(str(tmp_path))
  assert glob.glob(os.path.join(d, "*.pt.trace.json"))


@pytest.mark.parametrize("sync", [None, "tensor", "device"])
def test_timer_matches_reference(capsys, sync):
  arg = {None: None, "tensor": torch.ones(4),
         "device": torch.device("cpu")}[sync]
  with profiling.timer("step", sync=arg) as box:
    torch.ones(8).sum()
  assert box["seconds"] >= 0
  out = capsys.readouterr().out
  assert out.startswith("step: ") and out.endswith(" ms\n")
  with profiling.timer() as box:
    pass
  assert "seconds" in box and capsys.readouterr().out == ""


def test_annotate_keeps_the_function():
  def work(a, b=2):
    return a * b

  wrapped = profiling.annotate("span")(work)
  assert wrapped.__name__ == "work"
  assert wrapped(3, b=4) == 12
  anon = profiling.annotate("named")(lambda: 1)
  assert anon() == 1


def test_profiling_names_match_reference():
  from crackle_tpu.utils import profiling as rprof
  import inspect
  for name in ("trace", "timer", "annotate"):
    want = [p.name for p in inspect.signature(
      getattr(rprof, name)).parameters.values()]
    assert [p.name for p in inspect.signature(
      getattr(profiling, name)).parameters.values()] == want
  assert ct.utils.profiling is profiling


def device_kernels():
  """chip_smoke.py's DEVICE_KERNELS: wrapper -> the device kernels a
  trace shows for one launch of it."""
  import importlib.util
  spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))), "chip_smoke.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod.DEVICE_KERNELS


def test_device_kernel_names_match_the_sources():
  """chip_smoke.py's DEVICE_KERNELS, by which a trace is searched for a
  wrapper's kernels, names each wrapper of LAUNCHES and only kernels
  csrc/ defines."""
  import re
  from crackle_tpu_torch.kernels import _build
  defined = set()
  for path in glob.glob(os.path.join(_build.CSRC, "*.cu")):
    with open(path) as f:
      defined |= set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
        r"(\w+)_kernel\s*\(", f.read()))
  table = device_kernels()
  assert set(table) == set(_build.LAUNCHES)
  used = {n for names in table.values() for n in names}
  assert used == defined
