"""The port's CCL and label paint (plain version of the ccl_paint kernel
on the CPU) equal the JAX CCL, the numpy oracle and the Pallas paint."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from crackle_tpu.kernels import ccl_pallas
from crackle_tpu.kernels import decode as jdec
from crackle_tpu.ops.ccl import connected_components_slice
from crackle_tpu_torch.kernels import ccl

_xla_ccl = jax.jit(jdec._ccl_batch, static_argnums=(1, 2))


def labels_to_vcg(labels):
  """(B, sy, sx) labels -> 4-bit VCG: bit 0 x+1, bit 1 x-1, bit 2 y+1,
  bit 3 y-1 neighbour has the same label."""
  v = np.zeros(labels.shape, np.int32)
  v[:, :, :-1] |= (labels[:, :, :-1] == labels[:, :, 1:]) * 0b0001
  v[:, :, 1:] |= (labels[:, :, 1:] == labels[:, :, :-1]) * 0b0010
  v[:, :-1, :] |= (labels[:, :-1, :] == labels[:, 1:, :]) * 0b0100
  v[:, 1:, :] |= (labels[:, 1:, :] == labels[:, :-1, :]) * 0b1000
  return v


def smooth_labels(B, sy, sx, n, seed, rounds=4):
  rng = np.random.RandomState(seed)
  labels = rng.randint(0, n, size=(B, sy, sx)).astype(np.int32)
  for _ in range(rounds):
    ax = rng.randint(1, 3)
    m = rng.rand(B, sy, sx) < 0.6
    labels = np.where(m, np.roll(labels, 1, axis=ax), labels)
  return labels


@pytest.mark.parametrize("sy,sx", [(40, 48), (41, 48), (1, 7), (9, 1),
                                   (17, 33)])
def test_ccl_matches_xla(sy, sx):
  """Random connectivity bits (the sweep-variant inputs of
  test_jax_decode) against decode._ccl_batch."""
  rng = np.random.RandomState(sy * 100 + sx)
  vcg = (rng.randint(0, 16, size=(3, sy, sx)) & 0b1010).astype(np.int32)
  want_cc, want_N = _xla_ccl(jnp.asarray(vcg.reshape(3, -1)), sx, sy)
  cc, N, painted = ccl.ccl_paint(torch.from_numpy(vcg))
  assert painted is None
  assert cc.dtype == torch.int32 and N.dtype == torch.int32
  np.testing.assert_array_equal(cc.numpy(), np.asarray(want_cc))
  np.testing.assert_array_equal(N.numpy(), np.asarray(want_N))


@pytest.mark.parametrize("seed", [0, 1])
def test_ccl_matches_numpy_oracle(seed):
  labels = smooth_labels(2, 30, 26, 5, seed)
  cc, N, _ = ccl.ccl_paint(torch.from_numpy(labels_to_vcg(labels)))
  for z in range(2):
    want, n = connected_components_slice(labels[z].ravel(), 26, 30)
    np.testing.assert_array_equal(cc[z].numpy(), want.astype(np.int32))
    assert int(N[z]) == n


@pytest.mark.parametrize("K", [1, 2])
def test_paint_matches_pallas_interpret(monkeypatch, K):
  monkeypatch.setattr(ccl_pallas, "INTERPRET", True)
  rng = np.random.RandomState(10 + K)
  B, sy, sx, cap_n = 2, 24, 40, 512
  vcg = labels_to_vcg(smooth_labels(B, sy, sx, 6, K))
  T = rng.randint(-(1 << 31), 1 << 31, size=(B, K, cap_n),
                  dtype=np.int64).astype(np.int32)
  want_cc, want_N, want_p = ccl_pallas.ccl_paint_traced(
    jnp.asarray(vcg.reshape(B, -1)), jnp.asarray(T), sx, sy)
  cc, N, painted = ccl.ccl_paint(torch.from_numpy(vcg), torch.from_numpy(T))
  np.testing.assert_array_equal(cc.numpy(), np.asarray(want_cc))
  np.testing.assert_array_equal(N.numpy(), np.asarray(want_N))
  np.testing.assert_array_equal(painted.numpy(), np.asarray(want_p))


def test_paint_past_cap_n_is_zero():
  labels = smooth_labels(1, 16, 16, 8, 3, rounds=1)
  vcg = torch.from_numpy(labels_to_vcg(labels))
  cc, N, _ = ccl.ccl_paint(vcg)
  cap_n = 8
  assert int(N[0]) > cap_n
  T = torch.arange(1, cap_n + 1, dtype=torch.int32).reshape(1, 1, cap_n)
  cc2, _, painted = ccl.ccl_paint(vcg, T)
  assert torch.equal(cc, cc2)
  want = torch.where(cc < cap_n, cc + 1, 0)
  assert torch.equal(painted[:, 0], want)


def test_ccl_paint_rejects_bad_inputs():
  vcg = torch.zeros((2, 4, 4), dtype=torch.int32)
  with pytest.raises(ValueError):
    ccl.ccl_paint(vcg.to(torch.int64))
  with pytest.raises(ValueError):
    ccl.ccl_paint(vcg, torch.zeros((2, 3, 8), dtype=torch.int32))
  with pytest.raises(ValueError):
    ccl.ccl_paint(vcg, torch.zeros((2, 1, ccl.PAINT_CAP_N + 1),
                                   dtype=torch.int32))
