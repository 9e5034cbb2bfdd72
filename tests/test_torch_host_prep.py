"""The port's host prep equals the JAX engine's: padded crack streams,
flat label tables and the per-slice plant tables."""
import glob
import os

import numpy as np
import pytest
import torch

import crackle_tpu as crackle
from crackle_tpu.headers import LabelFormat
from crackle_tpu.kernels import ccl_pallas
from crackle_tpu.kernels import engine as jeng
from crackle_tpu_torch.kernels import engine as teng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(glob.glob(os.path.join(ROOT, "tests/golden/fixtures/*.ckl")))
STREAMS = [p for p in FIXTURES
           if crackle.header(open(p, "rb").read()).label_format
           == LabelFormat.FLAT]
STREAMS.append(os.path.join(ROOT, "bench_data/connectomics_v2_256x256x128.ckl"))
PREP_KEYS = ("packed", "nbytes", "nodes", "n_chains")


def _read(path):
  with open(path, "rb") as f:
    return f.read()


@pytest.mark.parametrize("path", STREAMS, ids=os.path.basename)
def test_prepare_slice_inputs_matches_jax(path):
  binary = _read(path)
  sz = crackle.header(binary).sz
  for z0, z1 in [(0, sz), (sz // 3, sz - sz // 4)]:
    want = jeng.prepare_slice_inputs(binary, z0, z1)
    got = teng.prepare_slice_inputs(binary, z0, z1)
    for k in PREP_KEYS:
      assert got[k].dtype == want[k].dtype, k
      np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("path", STREAMS, ids=os.path.basename)
def test_flat_tables_and_plant_table_match_jax(path, monkeypatch):
  # the reference parks streams only where its plant kernel runs; the
  # interpreter flag makes that true on the CPU (no kernel runs here)
  monkeypatch.setattr(ccl_pallas, "INTERPRET", True)
  binary = _read(path)
  head = crackle.header(binary)
  for a, b in zip(teng._flat_label_tables(head, binary),
                  jeng._flat_label_tables(head, binary)):
    np.testing.assert_array_equal(a, b)
  want = jeng.upload_stream(binary)
  got = teng.upload_stream(binary, "cpu")
  assert (got is None) == (want is None)
  if want is None:
    return
  np.testing.assert_array_equal(got.T.numpy(), np.asarray(want.T))
  for k in PREP_KEYS:
    np.testing.assert_array_equal(getattr(got, k).numpy(),
                                  np.asarray(getattr(want, k)))
  np.testing.assert_array_equal(got.crcs.numpy(),
                                np.asarray(want.crcs).astype(np.int64))
  assert got.permissible == want.permissible


def test_params_from_jax_carries_reference_inputs():
  binary = _read(STREAMS[0])
  inputs = jeng.prepare_slice_inputs(binary, 0, 3)
  T = np.arange(3 * 8, dtype=np.int32).reshape(3, 1, 8)
  t = teng.params_from_jax(inputs, T, "cpu")
  assert t["packed"].dtype == torch.uint8
  for k in PREP_KEYS:
    np.testing.assert_array_equal(t[k].numpy(), inputs[k])
  np.testing.assert_array_equal(t["T"].numpy(), T)
