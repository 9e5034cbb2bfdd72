"""One run of one cell of BENCHMARK.json.

The cell names a configuration (configs/<config>.json: the volume and
its generator) and a traffic mix (traffic/<traffic>.json: the request
path, kinds/<path>.py, and its parameters). Set-up makes the volume from
the seed and warms every shape; the window then serves requests in a
closed loop with one client for --seconds; with --trace 1 a shorter
window runs under torch.profiler and each per-layer metric of the cell
is read by its reader, metrics/<metric>.py (or, where there is none,
metrics/<the name before its first dot>.py); on the card a reader that
finds nothing to read fails the run. Once the window has closed
and the program's state is freed, the kept answers are compared with
the plain reference. The last line of standard output is the result.
"""
import argparse
import gc
import importlib.util
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from . import guard, paths, roofline
from .trace import WINDOW, Trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# seconds of the traced window at most: some tens of thousands of device
# events, which the profiler keeps and the reduction reads in seconds
TRACE_SECONDS = 8.0
# device types on which a per-layer reader that finds nothing to read
# fails the run (a CPU run of the tests reads no device)
STRICT_DEVICES = ("cuda",)


class Declines(logging.Handler):
  """Counts the program's declines to the host codec (engine._fallback)."""

  def __init__(self):
    super().__init__(logging.WARNING)
    self.records = []

  def emit(self, record):
    msg = record.getMessage()
    if "declined" in msg:
      self.records.append(msg)


class Run:
  """What a path needs of the run: the seed, the data, the device and the
  program's modules."""

  def __init__(self, seed, config, traffic, device):
    self.seed = seed
    self.config = config
    self.traffic = traffic
    self.device = device
    import crackle_tpu_torch
    from crackle_tpu_torch import codec
    from crackle_tpu_torch.kernels import engine
    self.program, self.codec, self.engine = crackle_tpu_torch, codec, engine

  def sync(self):
    if torch.device(self.device).type == "cuda":
      torch.cuda.synchronize(self.device)


class Context:
  """What a per-layer reader may read: the path and its state, the trace
  of the window, the requests it served, and timers."""

  def __init__(self, run, path, trace, n, readers):
    self.run, self.path, self.trace, self.n = run, path, trace, n
    self.engine = run.engine
    self.roofline = roofline
    self._readers = readers
    self._values = {}

  def metric(self, name):
    """The reading of another per-layer metric, read once."""
    if name not in self._values:
      self._values[name] = self._readers[name].read(self)
    return self._values[name]

  def device_ms(self, fn, reps: int):
    """Mean device ms of fn between CUDA events; None off the card."""
    if torch.device(self.run.device).type != "cuda":
      return None
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
      a = torch.cuda.Event(enable_timing=True)
      b = torch.cuda.Event(enable_timing=True)
      a.record()
      fn()
      b.record()
      b.synchronize()
      out.append(a.elapsed_time(b))
    return float(np.mean(out))

  def host_ms(self, fn, reps: int):
    """Mean host-clock ms of fn."""
    fn()
    t = time.perf_counter()
    for _ in range(reps):
      fn()
    return 1e3 * (time.perf_counter() - t) / reps


def load_module(path: str, name: str):
  spec = importlib.util.spec_from_file_location(name, path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def load_json(*parts):
  with open(os.path.join(*parts)) as f:
    return json.load(f)


def cell_metrics(bench, cell):
  """The cell's end-to-end metrics and its per-layer ones."""
  e2e = [m for m in bench["end_to_end"]
         if cell["name"] in m.get("workloads", [cell["name"]])]
  names = {m["name"] for m in e2e}
  layer = [m for m in bench["per_layer"]
           if (cell["name"] in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
  return e2e, layer


def reader(here: str, name: str):
  """The reader of per-layer metric `name`: metrics/<name>.py, or the
  one all metrics of its prefix share, metrics/<prefix>.py."""
  own = os.path.join(here, "metrics", f"{name}.py")
  if not os.path.exists(own):
    own = os.path.join(here, "metrics", f"{name.split('.')[0]}.py")
  return load_module(own, name)


def serve(path, seconds: float, limit: int):
  """The closed loop: requests back to back until `seconds` have passed
  (the last one runs to its end). Returns (times, voxels, failed,
  window seconds)."""
  times, voxels, failed = [], [], 0
  t0 = time.perf_counter()
  end = t0
  i = 0
  while end - t0 < seconds and i < limit:
    s = time.perf_counter()
    try:
      out = path.request(i)
    except Exception:  # noqa: BLE001 - a request that fails is counted
      failed += 1
      if failed == 1:
        logging.exception("request %d failed", i)
      out = None
    end = time.perf_counter()
    times.append(end - s)
    voxels.append(path.request_voxels(i))
    if out is not None:
      path.keep(i, out)
    i += 1
  return times, voxels, failed, end - t0


def parse(argv):
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seed", type=int, required=True)
  ap.add_argument("--seconds", type=float, required=True)
  ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
  return ap.parse_args(argv)


def main(argv, t_start=None, device="cuda", root=ROOT, overrides=None,
         control=None):
  """Run one cell once. device="cpu" and overrides (keys of the
  configuration and of the mix) serve the tests, which drive a run on
  the CPU at a small size; a run for a result takes the card. control
  names one of the path's CONTROLS, which then answers every request of
  the window in the program's place (control.py)."""
  t_start = time.perf_counter() if t_start is None else t_start
  args = parse(argv)
  bench = load_json(root, "BENCHMARK.json")
  cells = {c["name"]: c for c in bench["workloads"]}
  if args.workload not in cells:
    print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
    return 2
  cell = cells[args.workload]
  here = os.path.join(root, bench["paths"][0])
  config = load_json(here, "configs", f"{cell['config']}.json")
  traffic = load_json(here, "traffic", f"{cell['traffic']}.json")
  for k, v in (overrides or {}).items():
    (config if k in config else traffic)[k] = v
  if device == "cuda" and (not torch.cuda.is_available()
                           or torch.cuda.device_count() < cell["chips"]):
    print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
          f"found {torch.cuda.device_count()}", file=sys.stderr)
    return 2
  e2e, layer = cell_metrics(bench, cell)
  readers = {m["name"]: reader(here, m["name"]) for m in layer}

  declines = Declines()
  logger = logging.getLogger("crackle_tpu_torch.engine")
  logger.addHandler(declines)
  try:
    return _run(args, cell, config, traffic, device, e2e, layer, readers,
                declines, t_start, here, control)
  finally:
    logger.removeHandler(declines)


def _run(args, cell, config, traffic, device, e2e, layer, readers, declines,
         t_start, here, control):
  run = Run(args.seed, config, traffic, device)
  path = paths.kind(here, traffic["path"])(run)
  path.setup()
  if control is not None:
    path.request = path.control(control)
  run.sync()
  on_card = torch.device(device).type == "cuda"
  if on_card:
    torch.cuda.reset_peak_memory_stats()
  setup_s = time.perf_counter() - t_start

  tr = None
  if args.trace:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
      acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
      with torch.profiler.record_function(WINDOW):
        times, voxels, failed, window_s = serve(
          path, min(args.seconds, TRACE_SECONDS), traffic["max_requests"])
    tr = Trace.from_profiler(prof)
    del prof
  else:
    times, voxels, failed, window_s = serve(path, args.seconds,
                                            traffic["max_requests"])
  peak = torch.cuda.max_memory_allocated() if on_card else 0
  n = len(times)

  metrics = {}
  if args.trace:
    ctx = Context(run, path, tr, n, readers)
    for m in layer:
      v = ctx.metric(m["name"])
      if v is not None:
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    silent = [m["name"] for m in layer if m["name"] not in metrics]
    if torch.device(device).type in STRICT_DEVICES and silent:
      # the program no longer offers what a reader reads: fail loudly
      print(f"per-layer metrics with nothing to read: {silent}",
            file=sys.stderr)
      return 4
  else:
    stats = traffic["end_to_end"]
    for m in e2e:
      v = setup_s if m["name"] == "setup_s" else path.statistic(
        stats[m["name"]], times, voxels, window_s)
      metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

  # the program's state goes before the reference runs
  path.release()
  gc.collect()
  if on_card:
    torch.cuda.empty_cache()
  checks = path.check()
  checks["unanswered"] = int(not path.kept_answers())
  checks["failed_requests"] = failed
  checks["engine_declines"] = len(declines.records)
  for msg in declines.records[:5]:
    print(f"decline: {msg}", file=sys.stderr)
  limits = {k: 0 for k in checks}
  correct = all(checks[k] <= limits[k] for k in checks) and n > 0

  found = guard.forbidden_loaded()
  if found:
    print(f"forbidden modules loaded: {found}", file=sys.stderr)
    return 3

  dev = {"platform": "gpu" if on_card else "cpu",
         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
         "count": cell["chips"], "memory_peak_bytes": int(peak)}
  out = {"correct": bool(correct), "attempted": n, "failed": failed,
         "metrics": metrics, "device": dev}
  if tr is not None:
    dev["busy_s"] = tr.busy_s
    dev["window_s"] = tr.window_s
    out["breakdown"] = {"device_ops": tr.device_ops(),
                        "idle_gaps": tr.idle_gaps()}
  out["checks"] = {k: {"value": int(checks[k]), "limit": limits[k]}
                   for k in checks}
  for k in checks:
    print(f"check {k} {int(checks[k])} limit {limits[k]}", file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(out), flush=True)
  return 0
