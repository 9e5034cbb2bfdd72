"""The plain reference: the volume comparison, the narrowed labels of
the controls, the roofline counts and the import guard."""
import numpy as np
import pytest
import torch

from bench_port import guard, roofline
from bench_port.gen import connectomics, watershed
from bench_port.reference import volume

SHAPE = (36, 30, 10)


def test_crc_gate_bytes_count_the_work_alone():
  """The gate's bytes follow from the slices' shape, whatever dtype the
  implementation keeps its words in."""
  B, sy, sx = 512, 512, 512
  assert roofline.crc_gate_bytes(B, sy, sx) == B * sy * sx * 4 + 8 * B
  assert roofline.bytes_bound_ms(roofline.crc_gate_bytes(B, sy, sx)) == \
    pytest.approx(0.1603, rel=1e-3)


def test_flat_decode_bounds_by_bytes():
  io = roofline.flat_decode_io(512, 4096, 512, 512, 512, 1, 1024)
  for k in roofline.FLAT_DECODE:
    assert roofline.bound(k, *io[k])[3] == "bytes"


def test_volume_mismatches():
  t = connectomics.make(SHAPE, 2, "cpu")
  got = t.clone().reshape(SHAPE[2], -1)
  assert volume.mismatches(got, t) == 0
  got.view(torch.int32)[1, 5] += 1
  assert volume.mismatches(got, t) == 1
  host = t.numpy()
  out = np.asfortranarray(host.T)
  assert volume.mismatches_host(out, host) == 0
  assert volume.mismatches_host(out[:, :, :-1], host) == host.size


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_narrowed_keeps_the_low_bits(bits):
  """The controls' labels: stored in `bits` bits and read back, alike on
  a tensor and a numpy array, and exact where every label fits."""
  t = watershed.make(SHAPE, 4, "cpu")
  host = t.numpy()
  want = host & np.uint64((1 << bits) - 1)
  assert np.array_equal(volume.narrowed(t, bits).numpy(), want)
  assert np.array_equal(volume.narrowed(host, bits), want)
  assert volume.mismatches(volume.narrowed(t, bits), t) > 0
  c = connectomics.make(SHAPE, 4, "cpu")
  assert volume.mismatches(volume.narrowed(c, 16), c) == 0


def test_guard_compares_whole_top_level_names():
  assert guard.forbidden_loaded(["crackle_tpu_torch", "crackle_tpu_torch.x",
                                 "jaxtyping", "numpy"]) == []
  assert guard.forbidden_loaded(["crackle_tpu.codec"]) == ["crackle_tpu"]
  assert guard.forbidden_loaded(["jax", "jaxlib.xla", "flax"]) == [
    "flax", "jax", "jaxlib"]
