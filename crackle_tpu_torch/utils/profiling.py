"""Tracing and timing helpers on torch.profiler, the port of
crackle_tpu/utils/profiling.py (which uses the jax profiler)."""
import contextlib
import os
import tempfile
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
  """Capture a torch.profiler trace around a block, host and (where a
  card is present) CUDA activity, exported as a Chrome trace
  (<pid>.<ns>.pt.trace.json) into log_dir, a directory under the system's
  temp directory by default:

      with crackle_tpu_torch.utils.profiling.trace() as d:
          arr[:, :, 0:64]
      # open the trace in d with Perfetto or TensorBoard
  """
  from torch.profiler import ProfilerActivity, profile
  if log_dir is None:
    log_dir = os.path.join(tempfile.gettempdir(), "crackle_tpu_torch_trace")
  os.makedirs(log_dir, exist_ok=True)
  cuda = torch.cuda.is_available()
  activities = [ProfilerActivity.CPU]
  if cuda:
    activities.append(ProfilerActivity.CUDA)
  prof = profile(activities=activities)
  prof.start()
  try:
    yield log_dir
  finally:
    if cuda:
      torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(os.path.join(
      log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def _synchronize(sync) -> None:
  """Wait for the work queued on the device of sync: a tensor or a
  torch.device (the counterpart of jax.block_until_ready)."""
  device = sync.device if isinstance(sync, torch.Tensor) else \
    torch.device(sync)
  if device.type == "cuda":
    torch.cuda.synchronize(device)


@contextlib.contextmanager
def timer(name: str = "", sync=None):
  """Wall-clock a block; pass sync=tensor (or a torch.device) to wait
  for the device's work before the clock stops."""
  t0 = time.perf_counter()
  box = {}
  try:
    yield box
  finally:
    if sync is not None:
      _synchronize(sync)
    box["seconds"] = time.perf_counter() - t0
    if name:
      print(f"{name}: {box['seconds'] * 1e3:.1f} ms")


def annotate(name: str):
  """Named profiler span decorator for hot functions."""

  def deco(fn):
    def wrapped(*args, **kwargs):
      with torch.profiler.record_function(name):
        return fn(*args, **kwargs)
    wrapped.__name__ = getattr(fn, "__name__", name)
    return wrapped
  return deco
