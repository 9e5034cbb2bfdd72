"""Reduce a torch.profiler trace of the measured window to the numbers a
run reports: the device's busy time, its operations by time, the idle
gaps by what the host was doing, and the device time of named kernels.

The profiler's Chrome trace is read back as JSON: device work is every
event of the categories below, host work every CPU-side event. The
window is the span of the `WINDOW` annotation the harness puts around
the traced requests.
"""
import heapq
import json
import os
import re
import tempfile

WINDOW = "bench_port_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
TOP = 10


def _clean(name: str) -> str:
  return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


class Trace:
  """Device and host intervals (µs) of one traced window."""

  def __init__(self, events):
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not win:
      raise ValueError("the trace holds no window annotation")
    self.t0 = float(win[0]["ts"])
    self.t1 = self.t0 + float(win[0]["dur"])
    self.device = []
    self.host = []
    for e in events:
      if e.get("ph") != "X" or "dur" not in e:
        continue
      a, d = float(e["ts"]), float(e["dur"])
      if a + d <= self.t0 or a >= self.t1:
        continue
      rec = (max(a, self.t0), min(a + d, self.t1), e.get("name", ""))
      if e.get("cat") in DEVICE_CATS:
        self.device.append(rec)
      elif e.get("cat") in HOST_CATS and e.get("name") != WINDOW:
        self.host.append(rec)
    self.device.sort()

  @classmethod
  def from_profiler(cls, prof):
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
      prof.export_chrome_trace(path)
      with open(path) as f:
        events = json.load(f)["traceEvents"]
    finally:
      os.remove(path)
    return cls(events)

  @property
  def window_s(self) -> float:
    return (self.t1 - self.t0) * 1e-6

  def busy_intervals(self):
    """The union of device intervals, in order."""
    out = []
    for a, b, _ in self.device:
      if out and a <= out[-1][1]:
        out[-1][1] = max(out[-1][1], b)
      else:
        out.append([a, b])
    return out

  @property
  def busy_s(self) -> float:
    return sum(b - a for a, b in self.busy_intervals()) * 1e-6

  def kernel_s(self, names) -> float:
    """Device seconds of the kernels whose trace name holds
    f"{name}_kernel" as a whole word, for any of `names`."""
    pat = re.compile(r"\b(" + "|".join(re.escape(n) for n in names)
                     + r")_kernel\b")
    return sum(b - a for a, b, n in self.device if pat.search(n)) * 1e-6

  def device_ops(self):
    """The TOP device operations by summed seconds."""
    tot = {}
    for a, b, n in self.device:
      k = _clean(n)
      tot[k] = tot.get(k, 0.0) + (b - a) * 1e-6
    return sorted(([k, v] for k, v in tot.items()),
                  key=lambda kv: -kv[1])[:TOP]

  def idle_gaps(self):
    """The TOP idle gaps of the device, summed by the innermost host
    event (the latest started) that covers each gap's middle
    ("untraced_host_work" where none does)."""
    busy = self.busy_intervals()
    edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
    host = sorted(self.host)
    active, h, tot = [], 0, {}
    for a, b in zip(edges[0::2], edges[1::2]):
      if b <= a:
        continue
      mid = 0.5 * (a + b)
      while h < len(host) and host[h][0] <= mid:
        heapq.heappush(active, (-host[h][0], host[h][1], host[h][2]))
        h += 1
      while active and active[0][1] < mid:
        heapq.heappop(active)
      k = _clean(active[0][2]) if active else "untraced_host_work"
      tot[k] = tot.get(k, 0.0) + (b - a) * 1e-6
    return sorted(([k, v] for k, v in tot.items()),
                  key=lambda kv: -kv[1])[:TOP]
