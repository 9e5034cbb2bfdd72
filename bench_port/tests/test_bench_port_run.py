"""Whole runs of each cell on the CPU at a small size: the result line,
the faults that must make `correct` false, the controls, and a cell
added by new files alone."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from bench_port import control, harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
  os.path.abspath(__file__))))
SMALL = {"shape": [40, 36, 16], "warm": 1}
CELLS = ["connectomics_u32_512.resident_decode",
         "connectomics_u32_512.decompress"]
SEED = (1 << 31) + 77


@pytest.fixture(autouse=True)
def engine_restored():
  from crackle_tpu_torch import codec
  yield
  codec.set_engine("auto")


def run(capsys, workload, trace=0, root=ROOT, device="cpu", overrides=SMALL):
  rc = harness.main(["--workload", workload, "--seed", str(SEED),
                     "--seconds", "0.5", "--trace", str(trace)],
                    device=device, root=root, overrides=dict(overrides))
  assert rc == 0
  out = capsys.readouterr().out.strip().splitlines()
  return json.loads(out[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_is_correct(capsys, workload, trace):
  res = run(capsys, workload, trace)
  assert res["correct"] is True and res["attempted"] > 0
  assert res["failed"] == 0
  assert list(res)[-1] == "checks"
  bench = harness.load_json(ROOT, "BENCHMARK.json")
  cell = {c["name"]: c for c in bench["workloads"]}[workload]
  e2e, layer = harness.cell_metrics(bench, cell)
  if trace:
    assert set(res["metrics"]) <= {m["name"] for m in layer}
    assert "breakdown" in res and "busy_s" in res["device"]
  else:
    assert set(res["metrics"]) == {m["name"] for m in e2e}


def _alter(x):
  """One value of an answer changed where it is produced."""
  if isinstance(x, torch.Tensor):
    x = x.clone()
    x.reshape(-1).view(torch.uint8)[0] ^= 1
    return x
  x = x.copy(order="A")
  x.reshape(-1, order="A").view(np.uint8)[0] ^= 1
  return x


def _half(x):
  """Half of the slices left out: the second half of z zeroed."""
  if isinstance(x, torch.Tensor):
    x = x.clone()
    x[x.shape[0] // 2:] = 0
    return x
  x = x.copy(order="A")
  x[..., x.shape[-1] // 2:] = 0
  return x


FAULTS = ["altered", "half"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_path_is_not_correct(capsys, monkeypatch, workload, fault):
  from crackle_tpu_torch import codec
  from crackle_tpu_torch.kernels import engine
  hit = {"n": 0}

  def wrap(fn, pick):
    def inner(*a, **k):
      hit["n"] += 1
      return pick(fn(*a, **k))
    return inner

  bad = _alter if fault == "altered" else _half
  if workload.endswith("resident_decode"):
    orig = engine.DeviceStream.decode_window
    monkeypatch.setattr(engine.DeviceStream, "decode_window", wrap(
      orig, lambda r: (bad(r[0].reshape(r[2].shape[0], -1)), r[1], r[2])))
  else:
    monkeypatch.setattr(codec, "decompress", wrap(codec.decompress, bad))
  res = run(capsys, workload)
  assert hit["n"] > 0
  assert res["correct"] is False


def test_a_failing_request_is_not_correct(capsys, monkeypatch):
  from crackle_tpu_torch import codec

  def broken(*a, **k):
    raise RuntimeError("planted")
  res_ok = run(capsys, CELLS[1])
  assert res_ok["correct"]
  monkeypatch.setattr(codec, "decompress", broken)
  res = run(capsys, CELLS[1], overrides=dict(SMALL, warm=0))
  assert res["correct"] is False and res["failed"] == res["attempted"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_comparison(monkeypatch, capsys, workload):
  """At a size a test holds: a connectomics volume with more than 256
  labels, so that the narrowest control loses labels as at full size."""
  from bench_port.gen import connectomics
  monkeypatch.setattr(connectomics, "PER_PATCH", 600)
  lines = control.main(["--workload", workload, "--seconds", "0.3",
                        "--seeds", "5", "6"], device="cpu", overrides=SMALL)
  out = capsys.readouterr().out.strip().splitlines()
  assert all(x["rc"] == 0 for x in lines)
  for seed in (5, 6):
    assert any(x["correct"] is False for x in lines if x["seed"] == seed)
  # each control's own result line, printed by the harness, says so too
  results = [json.loads(o) for o in out if '"metrics"' in o]
  assert len(results) == len(lines)
  assert [r["correct"] for r in results] == [x["correct"] for x in lines]


SLICES = """
import numpy as np

from bench_port import paths
from bench_port.reference import volume


class Slices(paths.Path):
  def setup(self):
    truth = self.make_volume()
    self.binary = self.make_stream(truth)
    self.truth = truth.cpu().numpy()
    self.run.codec.set_engine(self.mix["engine"], device=self.dev)
    self.arr = self.run.program.CrackleArray(self.binary)
    self.sample = set()
    self.request(0)

  def request(self, i):
    z = i % self.shape[2]
    return z, self.arr[:, :, z:z + 1]

  def request_voxels(self, i):
    return self.shape[0] * self.shape[1]

  def check(self):
    return {"mismatched_voxels": sum(
      volume.mismatches_host(out, self.truth[z:z + 1])
      for z, out in self.kept_answers().values())}

  def statistic(self, kind, times, voxels, window_s):
    if kind == "p95_ms":
      return 1e3 * float(np.percentile(times, 95))
    return super().statistic(kind, times, voxels, window_s)


KIND = Slices
"""


def test_new_config_mix_and_metric_need_only_new_files(tmp_path, capsys):
  """A configuration, a traffic mix, a request path and a per-layer
  metric added as files of their own, with the entries of
  BENCHMARK.json, run with no other edit."""
  shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
  shutil.copytree(os.path.join(ROOT, "bench_port"), tmp_path / "bench_port",
                  ignore=shutil.ignore_patterns("__pycache__"))
  here = tmp_path / "bench_port"
  cfg = json.loads((here / "configs" / "connectomics_u32_512.json")
                   .read_text())
  cfg.update(name="connectomics_u32_small", shape=[24, 20, 6])
  (here / "configs" / "connectomics_u32_small.json").write_text(
    json.dumps(cfg))
  mix = {"why": "one-slice reads", "path": "slices", "engine": "torch",
         "end_to_end": {"slice_p95_ms": "p95_ms"}, "max_requests": 65536}
  (here / "traffic" / "zslices.json").write_text(json.dumps(mix))
  (here / "metrics" / "requests_traced.zslices.py").write_text(
    "def read(ctx):\n  return ctx.n\n")
  # a path of its own, with a statistic of its own
  (here / "kinds" / "slices.py").write_text(SLICES)
  bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
  name = "connectomics_u32_small.zslices"
  bench["configs"].append({"name": "connectomics_u32_small",
                           "source": "https://example.org/x",
                           "file": "bench_port/configs/"
                                   "connectomics_u32_small.json",
                           "reduced": [], "why": "a small test"})
  bench["workloads"].append({"name": name,
                             "config": "connectomics_u32_small",
                             "traffic": "zslices", "chips": 1,
                             "why": "a small test"})
  bench["end_to_end"].append({"name": "slice_p95_ms", "unit": "ms",
                              "better": "lower", "bound": 0.25,
                              "source": "host_clock", "workloads": [name]})
  bench["per_layer"].append({"name": "requests_traced.zslices",
                             "unit": "requests", "better": "higher",
                             "source": "program_counter",
                             "layer": "host arrays",
                             "moves": "slice_p95_ms", "workloads": [name]})
  (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
  res = run(capsys, name, root=str(tmp_path), overrides={})
  assert res["correct"] and "slice_p95_ms" in res["metrics"]
  res = run(capsys, name, trace=1, root=str(tmp_path), overrides={})
  assert res["metrics"]["requests_traced.zslices"]["value"] == \
    res["attempted"]


def test_a_silent_reader_fails_a_card_run(capsys, monkeypatch, tmp_path):
  """A per-layer reader that finds nothing to read: its metric is left
  out on the CPU, and a run on the card fails with its name."""
  shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
  shutil.copytree(os.path.join(ROOT, "bench_port"), tmp_path / "bench_port",
                  ignore=shutil.ignore_patterns("__pycache__"))
  (tmp_path / "bench_port" / "metrics" / "host_prep_ms.decompress.py"
   ).write_text("def read(ctx):\n  return None\n")
  res = run(capsys, CELLS[1], trace=1, root=str(tmp_path))
  assert "host_prep_ms.decompress" not in res["metrics"]
  assert "device_idle_pct.decompress" in res["metrics"]
  monkeypatch.setattr(harness, "STRICT_DEVICES", ("cpu", "cuda"))
  rc = harness.main(["--workload", CELLS[1], "--seed", "1", "--seconds",
                     "0.2", "--trace", "1"], device="cpu",
                    root=str(tmp_path), overrides=SMALL)
  cap = capsys.readouterr()
  assert rc != 0 and cap.out == "" and "host_prep_ms.decompress" in cap.err


def test_no_card_no_result(capsys, monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  rc = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1"])
  out = capsys.readouterr().out
  assert rc != 0 and out == ""


def test_forbidden_module_no_result(capsys, monkeypatch):
  import sys
  import types
  monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
  rc = harness.main(["--workload", CELLS[1], "--seed", "1", "--seconds",
                     "0.2"], device="cpu", overrides=SMALL)
  cap = capsys.readouterr()
  assert rc != 0 and cap.out == "" and "jax" in cap.err


@pytest.mark.cuda
def test_cells_on_card(capsys):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  for w in CELLS:
    res = run(capsys, w, device="cuda",
              overrides={"shape": [128, 128, 64], "warm": 1})
    assert res["correct"] and res["device"]["platform"] == "gpu"
