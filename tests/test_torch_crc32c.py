"""The port's CRC32C of word rows equals the byte-serial reference
(lib.crc32c) and the JAX device CRC (crc32c_tpu.crc32c_device)."""
import numpy as np
import pytest
import torch

from crackle_tpu.kernels import crc32c_tpu
from crackle_tpu.lib import crc32c
from crackle_tpu_torch.kernels.crc32c import crc32c_rows


def _reference(msgs):
  return np.array([crc32c(np.ascontiguousarray(m.astype('<u4')))
                   for m in msgs], np.int64)


@pytest.mark.parametrize("W", [1, 3, 129, 511, 512, 513, 4096])
def test_crc32c_rows_match_reference(W):
  rng = np.random.RandomState(W)
  msgs = rng.randint(0, 2 ** 32, size=(4, W), dtype=np.uint32)
  got = crc32c_rows(torch.from_numpy(msgs.view(np.int32)))
  assert got.dtype == torch.int64
  np.testing.assert_array_equal(got.numpy(), _reference(msgs))
  jax_got = np.asarray(crc32c_tpu.crc32c_device(msgs.view(np.int32)))
  np.testing.assert_array_equal(got.numpy(), jax_got.astype(np.int64))


def test_crc32c_rows_large_message():
  """32 * W > 2^24 bits per row: parities must stay exact per plane."""
  rng = np.random.RandomState(11)
  W = 600_001
  msgs = rng.randint(0, 2 ** 32, size=(2, W), dtype=np.uint32)
  got = crc32c_rows(torch.from_numpy(msgs.view(np.int32)))
  np.testing.assert_array_equal(got.numpy(), _reference(msgs))


def test_crc32c_rows_of_cc_images():
  """Small non-negative words, as the decoder's cc images are."""
  rng = np.random.RandomState(3)
  cc = rng.randint(0, 700, size=(3, 4096)).astype(np.int32)
  got = crc32c_rows(torch.from_numpy(cc))
  np.testing.assert_array_equal(got.numpy(),
                                _reference(cc.view(np.uint32)))
