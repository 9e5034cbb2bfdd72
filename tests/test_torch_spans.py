"""The program's spans and counters (crackle_tpu_torch/utils/profiling.py)
on the CPU: what the decode, upload and encode paths record under
recording() and under a torch.profiler session, and that they record
nothing, and touch neither record_function nor CUDA events, while
tracing is off.

The paths run on the torch engine with device "cpu" (the kernels' plain
versions); the streams are the port's own compress of seeded volumes.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

import crackle_tpu_torch as ct
from crackle_tpu_torch import codec
from crackle_tpu_torch.kernels import engine
from crackle_tpu_torch.utils import profiling

from test_jax_decode import random_volume
from test_torch_pins_encode import smooth_volume

DECODE_SPANS = {"codec.decompress", "codec.parse", "engine.prep",
                "engine.upload", "decode.replay_ccl", "engine.crc_gate",
                "engine.copy_back"}


@pytest.fixture
def torch_cpu():
  """The port's codec on the torch engine, on the CPU."""
  codec.set_engine("torch", device="cpu")
  yield
  codec.set_engine("auto")


def volume():
  return random_volume((24, 16, 5), 6, 11, smooth=4)


def stream():
  return codec.compress(volume())


def names(recs):
  return [s.name for s in recs]


def only(recs, name):
  (s,) = [s for s in recs if s.name == name]
  return s


def ancestors(recs, s):
  """The names of s's ancestors, innermost first."""
  by_id = {r.id: r for r in recs}
  out = []
  while s.parent is not None:
    s = by_id[s.parent]
    out.append(s.name)
  return out


class Raises:
  def __init__(self, *a, **k):
    raise AssertionError("touched while tracing is off")


def test_off_records_nothing_and_touches_no_profiler_or_event(
    torch_cpu, monkeypatch):
  binary = stream()
  with profiling.recording():
    with profiling.span("before"):
      pass
  kept = list(profiling.spans())
  monkeypatch.setattr(torch.autograd.profiler, "record_function", Raises)
  monkeypatch.setattr(torch.profiler, "record_function", Raises)
  monkeypatch.setattr(torch.cuda, "Event", Raises)
  np.testing.assert_array_equal(codec.decompress(binary), volume())
  st = engine.upload_stream(binary, "cpu")
  st.decode_window(0, 5, check_crcs=True)
  profiling.count("host_syncs")
  assert list(profiling.spans()) == kept
  assert [s.counters for s in kept] == [{}]


@pytest.fixture(params=["recording", "profiler"])
def tracing(request):
  """Tracing on: recording() or a torch.profiler session."""
  if request.param == "recording":
    return profiling.recording
  return lambda: torch.profiler.profile(
    activities=[torch.profiler.ProfilerActivity.CPU])


def test_decompress_spans_nest_under_one_request(torch_cpu, tracing):
  binary = stream()
  with tracing():
    out = codec.decompress(binary)
  recs = profiling.spans()
  assert recs.dropped == 0
  assert set(names(recs)) == DECODE_SPANS
  root = recs[0]
  assert root.name == "codec.decompress" and root.parent is None
  assert names(recs).count("codec.decompress") == 1
  assert {s.request for s in recs} == {root.request}
  for s in recs[1:]:
    assert ancestors(recs, s)[-1] == "codec.decompress"
    assert s.end_ns is not None and root.start_ns <= s.start_ns
    assert s.end_ns <= root.end_ns and s.device_ms is None
  for name in ("engine.prep", "decode.replay_ccl", "engine.crc_gate",
               "engine.copy_back", "engine.upload"):
    assert any(ancestors(recs, s) == ["codec.decompress"]
               for s in recs if s.name == name), name
  # the parse inside the prep is the prep's; the others the request's
  assert any(ancestors(recs, s)[0] == "engine.prep"
             for s in recs if s.name == "codec.parse")
  assert only(recs, "engine.copy_back").counters == {
    "d2h_bytes": out.nbytes, "host_syncs": 1}
  gate = only(recs, "engine.crc_gate")
  assert gate.counters == {"host_syncs": 1}  # the first mismatch's wait
  assert all(s.counters.get("host_syncs", 0) >= 1
             for s in recs if s.name == "engine.upload")


def test_resident_decode_and_upload_are_requests_of_their_own(tracing):
  binary = stream()
  with tracing():
    st = engine.upload_stream(binary, "cpu")
    st.decode_window(0, 5, check_crcs=True)
    st.decode_window(1, 3)
  recs = profiling.spans()
  roots = [s for s in recs if s.parent is None]
  assert names(roots) == ["engine.upload_stream"] + [
    "DeviceStream.decode_window"] * 2
  assert len({s.request for s in roots}) == 3
  kids = {r.request: [s.name for s in recs
                      if s.request == r.request and s is not r]
          for r in roots}
  assert set(kids[roots[0].request]) == {"codec.parse", "engine.prep",
                                         "engine.upload"}
  assert kids[roots[1].request] == ["decode.replay_ccl", "engine.crc_gate"]
  assert kids[roots[2].request] == ["decode.replay_ccl"]


def test_encode_spans(tracing):
  vol = volume()
  with tracing():
    binary = codec.compress(torch.from_numpy(vol))
  assert binary == stream()
  recs = profiling.spans()
  assert names(recs) == ["codec.compress", "encode.stage1",
                         "encode.assemble", "encode.trace"]
  assert ancestors(recs, recs[3]) == ["encode.assemble", "codec.compress"]
  # the N max and nonzero of the one batch, its table, and N, the CRCs
  # and the pairs to the host
  assert recs[1].counters["host_syncs"] == 6


def pins_volume():
  return smooth_volume((20, 18, 10), 4, 9, 12, np.uint8)


def pins_stream():
  binary = codec.compress(pins_volume(), allow_pins=1)
  assert codec.header(binary).label_format == 2
  return binary


def test_pins_decode_spans_split_the_ccl_and_the_paint(tracing):
  """A resident pins window: decode.pins_ccl with the window's slices
  as the roots its rank pass wrote, then decode.pins_paint with the
  window's table slots, once each inside decode.replay_ccl; one host
  sync a request, the gate's."""
  binary = pins_stream()
  st = engine.upload_stream(binary, "cpu")
  with tracing():
    for z0, z1 in ((0, 10), (2, 7)):
      st.decode_window(z0, z1, check_crcs=True)
  recs = profiling.spans()
  roots = [s for s in recs if s.parent is None]
  assert names(roots) == ["DeviceStream.decode_window"] * 2
  for r, (z0, z1) in zip(roots, ((0, 10), (2, 7))):
    kids = [s for s in recs if s.request == r.request and s is not r]
    assert names(kids) == ["decode.replay_ccl", "decode.pins_ccl",
                           "decode.pins_paint", "engine.crc_gate"]
    for s in kids[1:3]:
      assert ancestors(recs, s) == ["decode.replay_ccl",
                                    "DeviceStream.decode_window"]
    slots = sum(t[z0:z1].numel() for t in (st.pins[0], st.pins[2]))
    assert kids[1].counters == {"pins_roots_fused": z1 - z0}
    assert kids[2].counters == {"pins_slots": slots}
    assert sum(s.counters.get("host_syncs", 0) for s in kids) == 1


def test_pins_window_past_the_paint_cap_counts_no_fused_roots(
    monkeypatch):
  """A pins window with more components a slice than PAINT_CAP_N takes
  ccl_paint: decode.pins_ccl counts no pins_roots_fused, and the labels
  are those of the fused path."""
  from crackle_tpu_torch.kernels import ccl
  st = engine.upload_stream(pins_stream(), "cpu")
  want = st.decode_window(0, 10)
  monkeypatch.setattr(ccl, "PAINT_CAP_N", st.pins[5] - 1)
  with profiling.recording():
    got = st.decode_window(0, 10)
  (pins_ccl,) = [s for s in profiling.spans() if s.name == "decode.pins_ccl"]
  assert pins_ccl.counters == {}
  for g, w in zip(got, want):
    assert torch.equal(g, w)


def test_pins_window_decode_spans(torch_cpu):
  """codec.decompress of a pins stream on the torch engine: the same two
  spans inside decode.replay_ccl."""
  with profiling.recording():
    out = codec.decompress(pins_stream())
  np.testing.assert_array_equal(out, pins_volume())
  recs = profiling.spans()
  for name in ("decode.pins_ccl", "decode.pins_paint"):
    assert ancestors(recs, only(recs, name))[0] == "decode.replay_ccl"


@pytest.mark.parametrize("on_tensor", [False, True])
def test_pins_encode_spans_and_counters(on_tensor):
  """The host encoder (numpy) and the device one (a tensor): encode.pins
  holds encode.pins_columns and encode.pins_cover, and counts the
  candidate and the chosen pins."""
  vol = pins_volume()
  with profiling.recording():
    binary = codec.compress(torch.from_numpy(vol) if on_tensor else vol,
                            allow_pins=1)
  assert binary == pins_stream()
  recs = profiling.spans()
  pins = only(recs, "encode.pins")
  assert ancestors(recs, pins) == ["codec.compress"]
  for name in ("encode.pins_columns", "encode.pins_cover"):
    assert ancestors(recs, only(recs, name))[0] == "encode.pins"
  c = pins.counters
  assert 0 < c["pins_chosen"] < c["pins_candidates"]
  if on_tensor:
    assert names(recs)[:2] == ["codec.compress", "encode.stage1"]


def test_pins_spans_record_nothing_while_off(monkeypatch):
  vol = pins_volume()
  monkeypatch.setattr(torch.autograd.profiler, "record_function", Raises)
  monkeypatch.setattr(torch.cuda, "Event", Raises)
  with profiling.recording():
    with profiling.span("before"):
      pass
  kept = list(profiling.spans())
  binary = codec.compress(torch.from_numpy(vol), allow_pins=1)
  assert codec.compress(vol, allow_pins=1) == binary
  st = engine.upload_stream(binary, "cpu")
  st.decode_window(0, 10, check_crcs=True)
  assert list(profiling.spans()) == kept


def test_spans_close_on_an_exception(torch_cpu):
  binary = bytearray(stream())
  binary[-1] ^= 0xFF  # the last slice's stored crack CRC
  with profiling.recording():
    with pytest.raises(ct.headers.FormatError, match="crc mismatch on z=4"):
      codec.decompress(bytes(binary))
    with profiling.span("after"):
      pass
  recs = profiling.spans()
  assert all(s.end_ns is not None for s in recs)
  gate = only(recs, "engine.crc_gate")
  assert gate.counters["host_syncs"] == 3  # the gate's, and the message's
  assert "engine.copy_back" not in names(recs)
  assert recs[-1].name == "after" and recs[-1].parent is None
  assert recs[-1].request != recs[0].request


def test_counters_go_to_the_innermost_open_span():
  with profiling.recording():
    profiling.count("c")  # no span open: nothing to add to
    with profiling.span("outer"):
      profiling.count("c")
      with profiling.span("inner"):
        profiling.count("c", 2)
        profiling.count("d", 5)
      profiling.count("c")
  outer, inner = profiling.spans()
  assert outer.counters == {"c": 2}
  assert inner.counters == {"c": 2, "d": 5}
  assert inner.parent == outer.id and inner.request == outer.request


def test_a_span_directly_in_its_own_name_records_nothing():
  with profiling.recording():
    with profiling.span("a"):
      with profiling.span("a"):
        profiling.count("c")
        with profiling.span("b"):
          with profiling.span("a"):
            pass
  assert names(profiling.spans()) == ["a", "b", "a"]
  assert profiling.spans()[0].counters == {"c": 1}


def test_a_full_store_counts_what_it_drops(monkeypatch):
  monkeypatch.setattr(profiling, "MAX_SPANS", 3)
  with profiling.recording():
    with profiling.span("root"):
      for i in range(4):
        with profiling.span(f"child{i}"):
          profiling.count("c")
  recs = profiling.spans()
  assert names(recs) == ["root", "child0", "child1"]
  assert recs.dropped == 2
  with profiling.recording():
    with profiling.span("next"):
      pass
  assert names(profiling.spans()) == ["next"]
  assert profiling.spans().dropped == 0


def test_the_store_holds_the_latest_session_only():
  with profiling.recording():
    with profiling.span("first"):
      pass
  with profiling.span("off"):  # records nothing
    pass
  acts = [torch.profiler.ProfilerActivity.CPU]
  with torch.profiler.profile(activities=acts):
    with profiling.span("traced"):
      with profiling.recording():  # already on: the store stays
        with profiling.span("inner"):
          pass
  assert names(profiling.spans()) == ["traced", "inner"]
  with profiling.recording():
    pass
  assert names(profiling.spans()) == []


def test_annotate_is_a_span():
  work = profiling.annotate("work")(lambda x: x + 1)
  assert work(1) == 2
  with profiling.recording():
    assert work(2) == 3
  (s,) = profiling.spans()
  assert s.name == "work" and s.host_ms >= 0 and s.device_ms is None


def test_trace_of_a_cutout_names_the_spans(torch_cpu, tmp_path):
  arr = ct.CrackleArray(stream())
  with profiling.trace(str(tmp_path)) as d:
    got = arr[:, :, 1:4]
  np.testing.assert_array_equal(got, volume()[:, :, 1:4])
  (path,) = glob.glob(os.path.join(d, "*.pt.trace.json"))
  with open(path) as f:
    events = json.load(f)["traceEvents"]
  annotated = {e["name"] for e in events
               if e.get("cat") == "user_annotation"}
  assert DECODE_SPANS <= annotated


def test_threads_lose_no_span(monkeypatch):
  """Threads open spans into one store at once: every span is kept or
  counted as dropped, each thread's spans nest on its own stack."""
  import sys
  import threading
  monkeypatch.setattr(profiling, "MAX_SPANS", 1000)
  n_threads, n_spans = 16, 200
  old = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)

  def work():
    for _ in range(n_spans // 2):
      with profiling.span("outer"):
        with profiling.span("inner"):
          profiling.count("c")

  try:
    with profiling.recording():
      threads = [threading.Thread(target=work) for _ in range(n_threads)]
      for t in threads:
        t.start()
      for t in threads:
        t.join(timeout=60)
      assert not any(t.is_alive() for t in threads)
  finally:
    sys.setswitchinterval(old)
  recs = profiling.spans()
  assert len(recs) == 1000
  assert len(recs) + recs.dropped == n_threads * n_spans
  by_id = {s.id: s for s in recs}
  for s in recs:
    if s.name == "inner":
      assert s.counters == {"c": 1}
      if s.parent in by_id:
        assert by_id[s.parent].name == "outer"
        assert by_id[s.parent].request == s.request
