"""Tracing and timing helpers on torch.profiler, the port of
crackle_tpu/utils/profiling.py (which uses the jax profiler), and the
program's spans and counters.

A span names one layer's part of a request (codec.decompress,
engine.prep, decode.replay_ccl, engine.crc_gate, engine.copy_back, ...)
and a counter counts work at that boundary (host_syncs, d2h_bytes).
They record only while tracing is on: while a torch.profiler session
runs (trace() or any other), where each span is also a record_function
range on the trace's own clock, or inside recording(). Off, a span or a
count reads two flags and returns.

  with profiling.recording():
    arr[:, :, 0:64]
  for s in profiling.spans():
    print(s.name, s.request, s.parent, s.host_ms, s.device_ms, s.counters)
"""
import contextlib
import functools
import itertools
import os
import tempfile
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

# the most span records the store keeps; spans past it are counted in
# spans().dropped
MAX_SPANS = 1 << 17

_recording = 0       # recording() blocks open
_was_on = False      # whether the last span or count found recording on
_records = []        # the latest recording session's spans, in open order
_dropped = 0
_ids = itertools.count()
_requests = itertools.count()
_local = threading.local()
_store = threading.Lock()  # taken only while recording


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
  """Named span decorator for hot functions: each call runs in
  span(name)."""

  def deco(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
      with span(name):
        return fn(*args, **kwargs)
    return wrapped
  return deco


class _Off:
  """The span of a block while recording is off."""
  __slots__ = ()

  def __enter__(self):
    return None

  def __exit__(self, *exc):
    return False


_OFF = _Off()


class Span:
  """One recorded span: its name, its id, the id of its request (that of
  the root span it runs under), its parent span's id (None for a root),
  host start and end (time.perf_counter_ns; end None while open), its
  counters, and device_ms, the time between two CUDA events on the
  current stream of its device at its start (None without a CUDA
  device)."""
  __slots__ = ("name", "id", "request", "parent", "start_ns", "end_ns",
               "counters", "_device", "_events", "_rf", "_device_ms")

  def __init__(self, name: str, device):
    self.name = name
    self.id = next(_ids)
    self.request = self.parent = self.start_ns = self.end_ns = None
    self.counters = {}
    self._device = device
    self._events = self._rf = self._device_ms = None

  @property
  def host_ms(self) -> Optional[float]:
    if self.end_ns is None:
      return None
    return (self.end_ns - self.start_ns) * 1e-6

  @property
  def device_ms(self) -> Optional[float]:
    if self._events is not None and self.end_ns is not None:
      a, b, _ = self._events
      b.synchronize()
      self._device_ms = a.elapsed_time(b)
      self._events = None
    return self._device_ms

  def __enter__(self):
    global _dropped
    stack = _stack()
    if stack:
      self.parent, self.request = stack[-1].id, stack[-1].request
    else:
      self.request = next(_requests)
    with _store:
      if len(_records) < MAX_SPANS:
        _records.append(self)
      else:
        _dropped += 1
    stack.append(self)
    if _profiler._is_profiler_enabled:
      self._rf = _profiler.record_function(self.name)
      self._rf.__enter__()
    if self._device is not None:
      dev = torch.device(self._device)
      if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        a = torch.cuda.Event(enable_timing=True)
        a.record(stream)
        self._events = (a, torch.cuda.Event(enable_timing=True), stream)
    self.start_ns = time.perf_counter_ns()
    return self

  def __exit__(self, *exc):
    self.end_ns = time.perf_counter_ns()
    if self._events is not None:
      self._events[1].record(self._events[2])
    if self._rf is not None:
      self._rf.__exit__(*exc)
      self._rf = None
    _stack().pop()
    return False


def _stack():
  stack = getattr(_local, "stack", None)
  if stack is None:
    stack = _local.stack = []
  return stack


def _clear():
  global _dropped
  with _store:
    _records.clear()
    _dropped = 0


def _on() -> bool:
  """Whether spans record; empties the store where a profiler session
  has started since spans last found recording off."""
  global _was_on
  if not (_recording or _profiler._is_profiler_enabled):
    _was_on = False
    return False
  if not _was_on:
    _was_on = True
    _clear()
  return True


def span(name: str, device=None):
  """A context naming a block `name` while tracing is on (a
  torch.profiler session runs, or recording() is open): a record_function
  range while a profiler runs, and a Span in the store, with a pair of
  CUDA events on the current stream where `device` (anything
  torch.device takes) is a CUDA device. Spans nest per thread: one opened
  under none starts a request; one opened directly inside a span of its
  own name records nothing. Off, the block runs untouched."""
  if not _on():
    return _OFF
  stack = _stack()
  if stack and stack[-1].name == name:
    return _OFF
  return Span(name, device)


def count(name: str, n: int = 1) -> None:
  """Add n to counter `name` of this thread's innermost open span, while
  tracing is on."""
  if not _on():
    return
  stack = _stack()
  if stack:
    c = stack[-1].counters
    c[name] = c.get(name, 0) + n


class Spans(list):
  """The recorded spans in the order they opened, and `dropped`, the
  spans the full store did not keep."""

  def __init__(self, records, dropped: int):
    super().__init__(records)
    self.dropped = dropped


def spans() -> Spans:
  """The spans of the latest recording session: the store empties when
  recording() opens with recording off, and at the first span or count
  that finds a profiler running after spans last found recording off.
  Reading device_ms waits for the span's end event."""
  return Spans(_records, _dropped)


@contextlib.contextmanager
def recording():
  """Record spans without a profiler (no record_function ranges) for
  the block; the store is emptied where tracing was off."""
  global _recording, _was_on
  if not (_recording or _profiler._is_profiler_enabled):
    _clear()
    _was_on = True
  _recording += 1
  try:
    yield
  finally:
    _recording -= 1
