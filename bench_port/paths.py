"""What every request path shares, and where a traffic mix finds its
path: a mix's file names its path and its parameters, and the path is
the class KIND of the module kinds/<path>.py. Each path makes its inputs
from the seed in set-up, warms every shape its requests use, serves one
request a call, keeps a sample of the answers drawn from the seed, and
compares them with the plain reference once the window has closed.
"""
import importlib
import importlib.util
import os

import numpy as np


def _gen(config):
  return importlib.import_module(f"bench_port.gen.{config['generator']}")


class Path:
  """What every path shares: the volume, the stream and the sampling."""

  # the names of the path's controls (see control())
  CONTROLS = ()

  def __init__(self, run):
    self.run = run
    self.cfg = run.config
    self.mix = run.traffic
    self.dev = run.device
    self.shape = tuple(self.cfg["shape"])
    sx, sy, sz = self.shape
    self.voxels = sx * sy * sz
    self.rng = np.random.default_rng(run.seed % (1 << 64))
    self.kept = {}
    self.last = None

  def make_volume(self):
    """(sz, sy, sx) labels on the device, x fastest."""
    return _gen(self.cfg).make(self.shape, self.run.seed, self.dev)

  def make_stream(self, zyx):
    """The stream, written by the program's compress of the labels on
    the device (their (sx, sy, sz) view), in the configuration's format."""
    fmt = self.cfg.get("format", {})
    return self.run.codec.compress(
      zyx.permute(2, 1, 0), allow_pins=fmt.get("allow_pins", 0),
      markov_model_order=fmt.get("markov_model_order", 0))

  def keep_sample(self, n: int, within: int):
    """Request indices whose answers are kept: n drawn from the seed in
    [0, within), and the last request whatever its index."""
    self.sample = set(self.rng.choice(within, size=min(n, within),
                                      replace=False).tolist())

  def keep(self, i: int, out):
    if i in self.sample:
      self.kept[i] = out
    self.last = (i, out)

  def kept_answers(self):
    if self.last is not None:
      self.kept.setdefault(*self.last)
    return self.kept

  def release(self):
    """Drop the program's state before the reference runs."""

  def request_voxels(self, i: int) -> int:
    return self.voxels

  def statistic(self, kind: str, times, voxels, window_s: float) -> float:
    """An end-to-end metric from every request of the window, by the
    name the mix gives it; a path adds its own by overriding this."""
    if kind == "mvx_per_s":
      return sum(voxels) / window_s / 1e6
    raise ValueError(f"unknown statistic {kind}")

  def control(self, name: str):
    """A request function that answers in the program's place with the
    control `name` (one of CONTROLS), built after set-up: an answer one
    step below what the configuration states, which the cell's own
    comparison has to fail."""
    raise ValueError(f"no control {name!r}")


def kind(here: str, name: str):
  """The path a mix names: the class KIND of kinds/<name>.py."""
  spec = importlib.util.spec_from_file_location(
    f"bench_port_kind_{name}", os.path.join(here, "kinds", f"{name}.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod.KIND
