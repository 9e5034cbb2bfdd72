"""BENCHMARK.json against the rules a benchmark file keeps: names, units,
keys, lengths, the metrics each cell reports, and the files the harness
finds by name."""
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
  os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
  with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    return json.load(f)


def one_line(s):
  return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
    and "\t" not in s


def test_top_level_keys(bench):
  assert set(bench) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
  assert 1 <= len(bench["paths"]) <= 16
  for p in bench["paths"]:
    assert PATH.match(p) and not p.startswith("/") and ".." not in p
  assert len(bench["command"]) <= 32
  assert all(one_line(w) for w in bench["command"])
  assert isinstance(bench["run_seconds"], int)
  assert 1 <= bench["run_seconds"] <= 51
  assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_run_seconds_fit_a_full_check(bench):
  runs = 2 + 14 * 24
  need = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
  assert need <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_plain_and_unique(bench, section):
  names = [e["name"] for e in bench[section]]
  assert len(names) == len(set(names))
  assert all(NAME.match(n) for n in names)


def test_metric_fields(bench):
  for m in bench["end_to_end"] + bench["per_layer"]:
    assert UNIT.match(m["unit"]), m
    assert m["better"] in ("lower", "higher"), m
    assert m["source"] in SOURCES, m
  for m in bench["end_to_end"]:
    assert set(m) <= {"name", "unit", "better", "bound", "source",
                      "workloads"}
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
  for m in bench["per_layer"]:
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert one_line(m["layer"])
    if m["name"].split(".")[0].endswith("_roofline"):
      assert m["unit"] == "%"


def test_each_cell_reports_what_it_must(bench):
  e2e = {m["name"]: m for m in bench["end_to_end"]}
  assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
  for c in bench["workloads"]:
    got = {m for m, d in e2e.items()
           if c["name"] in d.get("workloads", [c["name"]])}
    assert "setup_s" in got and len(got) >= 2, c["name"]
    layer = [m for m in bench["per_layer"]
             if c["name"] in m.get("workloads", [])
             or ("workloads" not in m and m["moves"] in got)]
    assert layer, c["name"]


def test_moves_names_a_metric_every_listed_cell_reports(bench):
  e2e = {m["name"]: m for m in bench["end_to_end"]}
  for m in bench["per_layer"]:
    assert m["moves"] in e2e and m["moves"] != "setup_s", m["name"]
    for w in m.get("workloads", []):
      assert w in e2e[m["moves"]].get("workloads", [w]), (m["name"], w)


def test_layers_are_spelled_alike(bench):
  """Metrics of one layer give it letter for letter: no two spellings
  differ only in case or spacing."""
  layers = {m["layer"] for m in bench["per_layer"]}
  folded = {re.sub(r"\s+", " ", s.strip().lower()) for s in layers}
  assert len(folded) == len(layers)


def test_workloads_and_configs(bench):
  configs = {c["name"]: c for c in bench["configs"]}
  pairs = set()
  for c in bench["workloads"]:
    assert set(c) == {"name", "config", "traffic", "chips", "why"}
    assert c["config"] in configs and NAME.match(c["traffic"])
    assert c["chips"] in (1, 4) and one_line(c["why"])
    assert (c["config"], c["traffic"]) not in pairs
    pairs.add((c["config"], c["traffic"]))
  assert sum(c["chips"] == 4 for c in bench["workloads"]) <= max(
    1, len(bench["workloads"]) // 4)
  used = {c["config"] for c in bench["workloads"]}
  files = set()
  for c in bench["configs"]:
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["name"] in used and one_line(c["source"]) and one_line(c["why"])
    assert c["file"].startswith(bench["paths"][0] + "/")
    assert c["file"] not in files
    files.add(c["file"])
    with open(os.path.join(ROOT, c["file"])) as f:
      cfg = json.load(f)
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert len(c["reduced"]) <= 16


def test_every_named_file_is_there(bench):
  here = os.path.join(ROOT, bench["paths"][0])
  for c in bench["workloads"]:
    assert os.path.exists(os.path.join(here, "configs",
                                       f"{c['config']}.json"))
    assert os.path.exists(os.path.join(here, "traffic",
                                       f"{c['traffic']}.json"))
  for m in bench["per_layer"]:
    assert any(os.path.exists(os.path.join(here, "metrics", f"{n}.py"))
               for n in (m["name"], m["name"].split(".")[0])), m["name"]


def test_each_mix_computes_its_cells_end_to_end_metrics(bench):
  here = os.path.join(ROOT, bench["paths"][0])
  for c in bench["workloads"]:
    with open(os.path.join(here, "traffic", f"{c['traffic']}.json")) as f:
      mix = json.load(f)
    want = {m["name"] for m in bench["end_to_end"]
            if c["name"] in m.get("workloads", [c["name"]])} - {"setup_s"}
    assert set(mix["end_to_end"]) == want, c["name"]
    assert one_line(mix["why"])
