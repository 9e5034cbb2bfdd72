"""The condensed-pins cell on the CPU at a small size: a sound run is
correct and its stream is condensed pins, a flipped voxel and both
controls make `correct` false; the plain reference of the component ids
against the program's pins decode and the stored CRCs; the pins
kernels' roofline counts."""
import json
import os

import numpy as np
import pytest
import torch

from bench_port import control, harness, paths, pins_roofline, roofline
from bench_port.gen import connectomics
from bench_port.reference import components

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
  os.path.abspath(__file__))))
SMALL = {"shape": [40, 36, 16], "warm": 1}
CELL = "connectomics_pins_u32_512.resident_decode"
SEED = (1 << 31) + 91


@pytest.fixture(autouse=True)
def engine_restored():
  from crackle_tpu_torch import codec
  yield
  codec.set_engine("auto")


@pytest.fixture
def streams(monkeypatch):
  """The streams the runs write, as the harness's paths make them."""
  made = []
  orig = paths.Path.make_stream

  def spy(self, zyx):
    made.append(orig(self, zyx))
    return made[-1]
  monkeypatch.setattr(paths.Path, "make_stream", spy)
  return made


def run(capsys, trace=0, overrides=SMALL, seed=SEED):
  rc = harness.main(["--workload", CELL, "--seed", str(seed),
                     "--seconds", "0.5", "--trace", str(trace)],
                    device="cpu", root=ROOT, overrides=dict(overrides))
  assert rc == 0
  return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_pins_cell_runs_and_is_correct(capsys, streams, trace):
  from crackle_tpu_torch import codec
  res = run(capsys, trace)
  assert res["correct"] is True and res["attempted"] > 0
  assert res["failed"] == 0
  assert all(c["value"] == 0 for c in res["checks"].values())
  (binary,) = streams
  assert codec.header(binary).label_format == 2  # condensed pins
  if trace:
    # no CUDA kernel on the CPU: the roofline finds nothing to read
    assert "pins_kernels_roofline.decode" not in res["metrics"]
    assert "busy_s" in res["device"]
  else:
    assert set(res["metrics"]) == {"decode_mvx", "setup_s"}


def test_a_flipped_voxel_is_not_correct(capsys, monkeypatch):
  from crackle_tpu_torch.kernels import engine
  orig = engine.DeviceStream.decode_window

  def flipped(self, *a, **k):
    labels, cc, N = orig(self, *a, **k)
    labels = labels.clone()
    labels.reshape(-1).view(torch.uint8)[7] ^= 1
    return labels, cc, N
  monkeypatch.setattr(engine.DeviceStream, "decode_window", flipped)
  res = run(capsys)
  assert res["correct"] is False
  assert res["checks"]["mismatched_voxels"]["value"] > 0


def test_both_controls_fail_the_comparison(monkeypatch, capsys, streams):
  """A volume whose labels need more than 16 bits, as a segmentation's
  ids often do: the labels stored in 16 ("narrower") or 8 bits
  ("narrowest") lose them."""
  from crackle_tpu_torch import codec
  orig = connectomics.make
  monkeypatch.setattr(connectomics, "make", lambda *a: (
    orig(*a).view(torch.int32) + (1 << 16)).view(torch.uint32))
  lines = control.main(["--workload", CELL, "--seconds", "0.3",
                        "--seeds", "5", "6"], device="cpu",
                       overrides=SMALL)
  assert [x["control"] for x in lines] == ["narrower", "narrowest"] * 2
  assert all(x["rc"] == 0 and x["correct"] is False for x in lines)
  assert all(codec.header(b).label_format == 2 for b in streams)


@pytest.mark.parametrize("shape,seed", [((40, 36, 16), 3), ((33, 17, 9), 8),
                                        ((64, 48, 12), (1 << 33) + 5)])
def test_components_match_the_pins_decode_and_the_crcs(shape, seed):
  from crackle_tpu_torch import codec
  from crackle_tpu_torch.kernels import engine
  from crackle_tpu_torch.lib import crc32c
  truth = connectomics.make(shape, seed, "cpu")
  binary = codec.compress(truth.permute(2, 1, 0), allow_pins=1)
  assert codec.header(binary).label_format == 2
  want, want_n = components.components(truth)
  stream = engine.upload_stream(binary, "cpu")
  labels, cc, N = stream.decode_window(0, shape[2], check_crcs=True)
  assert torch.equal(cc, want) and torch.equal(N, want_n)
  assert torch.equal(labels.view(torch.int32),
                     truth.reshape(shape[2], -1).view(torch.int32))
  stored = codec.crack_crcs(binary)
  got = [crc32c(np.ascontiguousarray(want[z].numpy().astype("<u4")))
         for z in range(shape[2])]
  assert got == [int(c) for c in stored]


def test_components_of_single_labels_and_rings():
  """One label, one pixel a slice, and a ring around another label: a
  component whose least index its neighbours reach only the long way."""
  ring = torch.ones((1, 9, 9), dtype=torch.uint32)
  ring[0, 2:7, 2:7] = 2
  ring[0, 3:6, 3:6] = 1
  cases = [torch.zeros((2, 5, 7), dtype=torch.uint8),
           torch.zeros((3, 1, 1), dtype=torch.uint64), ring]
  for labels in cases:
    cc, N = components.components(labels)
    assert cc.shape == (labels.shape[0], labels.shape[1] * labels.shape[2])
    if labels is ring:
      want = torch.zeros(81, dtype=torch.int32)
      want.view(9, 9)[2:7, 2:7] = 1
      want.view(9, 9)[3:6, 3:6] = 2
      assert torch.equal(cc[0], want) and N.tolist() == [3]
    else:
      assert not cc.any() and N.eq(1).all()


def test_pins_bounds_count_each_launch_once():
  B, sx, sy, cap_n = 512, 512, 512, 641
  io = pins_roofline.pins_decode_io(B, sx, sy, cap_n)
  npx = B * sx * sy
  assert pins_roofline.roots_width(cap_n) == 1024
  assert pins_roofline.roots_width(3) == 8
  assert io["ccl_min"] == (12 * npx, npx)
  assert io["plant_k0"] == (8 * npx + B * 1024 * 4, npx)
  assert io["plant_k1"] == (12 * npx + 2 * B * 1024 * 4, npx)
  for k, w in pins_roofline.PINS_DECODE:
    assert roofline.bound(w, *io[k])[3] == "bytes"
  assert pins_roofline.pins_decode_bound_ms(B, sx, sy, cap_n) == \
    pytest.approx(1e3 * (32 * npx + 3 * B * 1024 * 4) / 3.35e12)
  assert set(pins_roofline.PINS_KERNELS) == {
    "ccl_local", "ccl_merge", "ccl_count", "ccl_rank", "plant_map", "plant"}


@pytest.mark.cuda
def test_pins_cell_on_card(capsys):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  rc = harness.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                     "1", "--trace", "1"], device="cuda", root=ROOT,
                    overrides={"shape": [128, 128, 64], "warm": 1})
  assert rc == 0
  res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert res["correct"] and res["device"]["platform"] == "gpu"
  assert 0 < res["metrics"]["pins_kernels_roofline.decode"]["value"] <= 100
  for name in ("crc_gate_ms.decode", "crc_gate_roofline.decode",
               "device_idle_pct.decode"):
    assert res["metrics"][name]["value"] > 0


@pytest.mark.cuda
def test_components_match_the_pins_decode_at_full_size():
  """The cell's 512^3 volume on the card: its pins stream decodes
  through ccl_min and plant (not the ccl_paint fallback) to the volume,
  and the decode's component ids equal the plain reference's."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  from bench_port.reference import volume
  from crackle_tpu_torch import codec
  from crackle_tpu_torch.kernels import _build, engine
  truth = connectomics.make((512, 512, 512), (1 << 31) + 3, "cuda")
  binary = codec.compress(truth.permute(2, 1, 0), allow_pins=1)
  assert codec.header(binary).label_format == 2
  stream = engine.upload_stream(binary, "cuda")
  _build.reset_launches()
  labels, cc, N = stream.decode_window(0, 512, check_crcs=True)
  launched = {k for k, v in _build.LAUNCHES.items() if v}
  assert {"ccl_min", "plant"} <= launched and "ccl_paint" not in launched
  assert volume.mismatches(labels, truth) == 0
  del labels, stream
  want, want_n = components.components(truth)
  assert torch.equal(cc, want) and torch.equal(N, want_n)
