"""The port's command line (crackle_tpu_torch/cli.py) against
crackle_tpu.cli, run in-process with click's CliRunner in two
directories that hold the same files, and the packaging that installs it.

The port runs under set_engine('numpy') and under set_engine('torch',
device="cpu"); the reference on its host engine.
"""
import os
import subprocess
import sys
import tomllib

import numpy as np
import pytest
from click.testing import CliRunner

import crackle_tpu as crackle
from crackle_tpu import cli as rcli
from crackle_tpu_torch import cli as tcli

from test_torch_array import engine, stream  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flip_crack_byte(binary, z):
  """binary with one byte in the middle of slice z's crack code flipped
  (its stored CRC left as it was)."""
  head = crackle.header(binary)
  codes = crackle.crack_codes(binary)
  trailer = (head.sz + 1) * 4 if head.format_version else 0
  end = len(binary) - trailer - sum(len(c) for c in codes[z + 1:])
  at = end - len(codes[z]) + len(codes[z]) // 2
  out = bytearray(binary)
  out[at] ^= 0x5A
  return bytes(out)


def files(name):
  """file name -> bytes of each case's inputs."""
  binary = stream(name)
  vol = crackle.decompress(binary)
  head = crackle.header(binary)
  bad = bytearray(binary)
  bad[12] ^= 0xFF  # a header byte: the header CRC fails
  return {"vol.ckl": binary, "vol.npy": _npy(vol),
          "cracked.ckl": flip_crack_byte(binary, head.sz // 2),
          "badhead.ckl": bytes(bad), "vol.bad": b"\0" * 32}


def _npy(vol):
  import io
  f = io.BytesIO()
  np.save(f, vol)
  return f.getvalue()


def run_both(tmp_path, monkeypatch, name, args):
  """(reference, port) of (exit code, stdout, exception type name, the
  directory's files afterwards) for one command line."""
  out = []
  for sub, main in (("ref", rcli.main), ("port", tcli.main)):
    d = tmp_path / sub
    d.mkdir()
    for fname, data in files(name).items():
      (d / fname).write_bytes(data)
    monkeypatch.chdir(d)
    res = CliRunner().invoke(main, args)
    exc = None
    if res.exception is not None and not isinstance(res.exception,
                                                    SystemExit):
      exc = type(res.exception).__name__
    after = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}
    out.append((res.exit_code, res.output, exc, after))
  return out


def npy_equal(a, b):
  import io
  return np.array_equal(np.load(io.BytesIO(a)), np.load(io.BytesIO(b)))


# command lines over the files of files()
COMMANDS = {
  "info": ["-i", "vol.ckl"],
  "info of two": ["-i", "vol.ckl", "cracked.ckl"],
  "labels": ["-l", "vol.ckl"],
  "test ok": ["-T", "vol.ckl"],
  "test a cracked slice": ["-T", "cracked.ckl"],
  "test a bad header": ["-T", "badhead.ckl"],
  "decompress keep": ["-d", "-k", "vol.ckl"],
  "decompress": ["-d", "vol.ckl"],
  "decompress a z range": ["-d", "-k", "-z", "1:3", "vol.ckl"],
  "decompress from z": ["-d", "-k", "-z", "2:", "vol.ckl"],
  "compress keep": ["-k", "vol.npy"],
  "compress": ["vol.npy"],
  "compress pins": ["-p", "-k", "vol.npy"],
  "compress optimal pins": ["-P", "-k", "vol.npy"],
  "compress markov": ["-m", "3", "-k", "vol.npy"],
  "reencode markov": ["-m", "2", "vol.ckl"],
  "meta": ["-M", "vol.ckl"],
  "unknown format": ["-k", "vol.bad"],
  "a bad header": ["-d", "-k", "badhead.ckl"],
  "help": ["--help"],
}


@pytest.mark.parametrize("command", list(COMMANDS))
@pytest.mark.parametrize("name", ["flat", "pins", "u64", "markov-5"])
def test_cli_matches_reference(engine, tmp_path, monkeypatch, name, command):
  """The same exit code, stdout, exception and files: .ckl and meta
  files byte for byte, .npy files by their arrays."""
  (rc, rout, rexc, rfiles), (pc, pout, pexc, pfiles) = run_both(
    tmp_path, monkeypatch, name, COMMANDS[command])
  assert (pc, pexc) == (rc, rexc)
  assert pout == rout
  assert list(pfiles) == list(rfiles)
  for f in rfiles:
    if f.endswith(".npy"):
      assert npy_equal(pfiles[f], rfiles[f]), f
    elif f.endswith(".meta"):
      import pyarrow.parquet as pq
      import io
      assert pq.read_table(io.BytesIO(pfiles[f])).to_pydict() == \
        pq.read_table(io.BytesIO(rfiles[f])).to_pydict()
    else:
      assert pfiles[f] == rfiles[f], f


def test_cli_names_the_cracked_slice(engine, tmp_path, monkeypatch):
  """-T of a stream with one crack byte flipped exits 1 and names its
  slice; -d -k writes the volume."""
  binary = stream("flat")
  z = crackle.header(binary).sz // 2
  (tmp_path / "x.ckl").write_bytes(flip_crack_byte(binary, z))
  (tmp_path / "y.ckl").write_bytes(binary)
  monkeypatch.chdir(tmp_path)
  res = CliRunner().invoke(tcli.main, ["-T", "x.ckl"])
  assert res.exit_code == 1
  assert f"damaged z slices: [{z}]" in res.output
  res = CliRunner().invoke(tcli.main, ["-d", "-k", "y.ckl"])
  assert res.exit_code == 0 and "wrote y.npy" in res.output
  np.testing.assert_array_equal(np.load(tmp_path / "y.npy"),
                                crackle.decompress(binary))


@pytest.mark.parametrize("before, card, during", [
  (("auto", "cuda"), True, ("torch", "cuda")),
  (("auto", "cuda"), False, ("auto", "cuda")),
  (("numpy", "cuda"), True, ("numpy", "cuda")),
  (("torch", "cpu"), True, ("torch", "cpu")),
])
def test_cli_takes_the_card_engine(monkeypatch, before, card, during):
  """A command runs on the torch engine on the card where one is present
  and the engine is 'auto' (which would decode flat streams and encode
  numpy on the host); an engine the caller set is kept, and the engine
  is as it was after the command."""
  from crackle_tpu_torch import codec as pcodec
  seen = []
  monkeypatch.setattr(tcli.torch.cuda, "is_available", lambda: card)
  monkeypatch.setattr(tcli, "print_header", lambda src: seen.append(
    (pcodec.get_engine(), pcodec._DEVICE)))
  pcodec.set_engine(*before)
  try:
    res = CliRunner().invoke(tcli.main, ["-i", "a.ckl", "b.ckl"])
    assert res.exit_code == 0, res.output
    assert seen == [during, during]
    assert (pcodec.get_engine(), pcodec._DEVICE) == before
  finally:
    pcodec.set_engine("auto")


def test_cli_runs_as_a_module(tmp_path):
  """python -m crackle_tpu_torch.cli, as the crackle-torch script runs
  main(), with no JAX and nothing of crackle_tpu loaded."""
  binary = stream("flat")
  (tmp_path / "v.ckl").write_bytes(binary)
  code = ("import runpy, sys; sys.argv = ['crackle-torch', '-i', 'v.ckl'];"
          "\ntry:\n  runpy.run_module('crackle_tpu_torch.cli', "
          "run_name='__main__')\nexcept SystemExit as e:\n  code = e.code\n"
          "bad = [m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'crackle_tpu')]\nprint('loaded', bad)\n"
          "sys.exit(code)")
  env = dict(os.environ, PYTHONPATH=ROOT)
  res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
  assert res.returncode == 0, res.stderr
  assert "v.ckl:" in res.stdout and "num labels:" in res.stdout
  assert "loaded []" in res.stdout


def _pyproject():
  with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
    return tomllib.load(f)


def test_pyproject_lists_every_subpackage():
  """Each directory of crackle_tpu_torch with an __init__.py is in
  packages, so that an installed wheel imports all of it."""
  listed = set(_pyproject()["tool"]["setuptools"]["packages"])
  pkg = os.path.join(ROOT, "crackle_tpu_torch")
  found = {os.path.relpath(d, ROOT).replace(os.sep, ".")
           for d, _, names in os.walk(pkg) if "__init__.py" in names}
  assert {"crackle_tpu_torch.parallel", "crackle_tpu_torch.utils"} <= found
  assert found <= listed


def test_pyproject_installs_the_cli():
  scripts = _pyproject()["project"]["scripts"]
  assert scripts["crackle-torch"] == "crackle_tpu_torch.cli:main"
  assert scripts["crackle"] == "crackle_tpu.cli:main"
