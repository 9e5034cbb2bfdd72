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


def serpentine_vcg(B, sy, sx):
  """One component that snakes through every row: each row is linked
  along x, and row y to row y - 1 only at its right end (y odd) or its
  left end (y even)."""
  v = np.zeros((B, sy, sx), np.int32)
  v[:, :, 1:] |= 0b0010
  v[:, :, :-1] |= 0b0001
  for y in range(1, sy):
    x = sx - 1 if y % 2 else 0
    v[:, y, x] |= 0b1000
    v[:, y - 1, x] |= 0b0100
  return v


def hard_vcgs():
  """name -> VCG of the topologies a tiled CCL finds hard: one snake
  through every tile, a checkerboard (N = n), one row, one column, rows
  of 100 that split across tiles, and everything connected (N = 1)."""
  yy, xx = np.indices((18, 22))
  return {
    "serpentine": serpentine_vcg(2, 15, 24),
    "checkerboard": labels_to_vcg(((yy + xx) % 2)[None]),
    "row": labels_to_vcg(smooth_labels(2, 1, 600, 5, 31)),
    "column": labels_to_vcg(smooth_labels(2, 600, 1, 5, 32)),
    "sx100": labels_to_vcg(smooth_labels(2, 30, 100, 6, 33)),
    "connected": labels_to_vcg(np.zeros((2, 20, 30), np.int32)),
  }


@pytest.mark.parametrize("name", sorted(hard_vcgs()))
def test_ccl_paint_hard_topologies_match_xla(name):
  """ccl_paint on the topologies of hard_vcgs against decode._ccl_batch,
  with a table smaller than N where there are many components."""
  vcg = hard_vcgs()[name]
  B, sy, sx = vcg.shape
  want_cc, want_N = _xla_ccl(jnp.asarray(vcg.reshape(B, -1)), sx, sy)
  want_cc, want_N = np.asarray(want_cc), np.asarray(want_N)
  if name == "checkerboard":
    assert int(want_N[0]) == sx * sy
  if name in ("serpentine", "connected"):
    assert want_N.tolist() == [1] * B
  cap_n = 64
  T = np.random.RandomState(len(name)).randint(
    1, 1 << 30, size=(B, 1, cap_n)).astype(np.int32)
  cc, N, painted = ccl.ccl_paint(torch.from_numpy(vcg), torch.from_numpy(T))
  np.testing.assert_array_equal(cc.numpy(), want_cc)
  np.testing.assert_array_equal(N.numpy(), want_N)
  want_p = np.where(want_cc < cap_n,
                    np.take_along_axis(T[:, 0], np.minimum(want_cc, cap_n - 1),
                                       1), 0)
  np.testing.assert_array_equal(painted[:, 0].numpy(), want_p)


@pytest.mark.parametrize("name", sorted(hard_vcgs()))
def test_ccl_min_hard_topologies_match_pallas_interpret(monkeypatch, name):
  monkeypatch.setattr(ccl_pallas, "INTERPRET", True)
  vcg = hard_vcgs()[name]
  B, sy, sx = vcg.shape
  want_L, want_tgt = ccl_pallas.ccl_min_traced(
    jnp.asarray(vcg.reshape(B, -1)), sx, sy)
  L, tgt = ccl.ccl_min(torch.from_numpy(vcg))
  np.testing.assert_array_equal(L.numpy(), np.asarray(want_L))
  np.testing.assert_array_equal(tgt.numpy(), np.asarray(want_tgt))


@pytest.mark.parametrize("tile", [0, 16, 48, 16384])
def test_tile_pix_must_be_a_power_of_two_in_range(monkeypatch, tile):
  monkeypatch.setattr(ccl, "TILE_PIX", tile)
  with pytest.raises(ValueError, match="TILE_PIX"):
    ccl._tiles("ccl_paint", torch.empty((1, 8, 8), dtype=torch.int32))


def test_tiles_cover_the_slice_and_refuse_2_31_pixels():
  assert ccl._tiles("ccl_min", torch.empty((3, 512, 512))) == (8192, 32)
  assert ccl._tiles("ccl_min", torch.empty((1, 30, 100))) == (8192, 1)
  big = torch.empty((1, 1 << 16, 1 << 15), device="meta")
  with pytest.raises(ValueError, match="2\\^31"):
    ccl._tiles("ccl_paint", big)


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


def _v2_inputs(seed, B=3, sy=24, sx=40):
  """The inputs of test_jax_decode.test_ccl_v2_plant_matches_v1."""
  return labels_to_vcg(smooth_labels(B, sy, sx, 6, seed))


@pytest.mark.parametrize("sy,sx", [(24, 40), (17, 33), (1, 7), (9, 1)])
def test_ccl_min_matches_pallas_interpret(monkeypatch, sy, sx):
  monkeypatch.setattr(ccl_pallas, "INTERPRET", True)
  vcg = _v2_inputs(sy + sx, 2, sy, sx)
  want_L, want_tgt = ccl_pallas.ccl_min_traced(
    jnp.asarray(vcg.reshape(2, -1)), sx, sy)
  L, tgt = ccl.ccl_min(torch.from_numpy(vcg))
  assert L.dtype == torch.int32 and L.shape == (2, sy, sx)
  np.testing.assert_array_equal(L.numpy(), np.asarray(want_L))
  np.testing.assert_array_equal(tgt.numpy(), np.asarray(want_tgt))


@pytest.mark.parametrize("K", [0, 1, 2])
def test_roots_and_plant_match_pallas_interpret(monkeypatch, K):
  monkeypatch.setattr(ccl_pallas, "INTERPRET", True)
  rng = np.random.RandomState(20 + K)
  B, sy, sx, cap_n = 3, 24, 40, 512
  vcg = jnp.asarray(_v2_inputs(11).reshape(B, -1))
  L, tgt = ccl_pallas.ccl_min_traced(vcg, sx, sy)
  want_roots, want_N = ccl_pallas.roots_from_tgt(tgt, cap_n)
  roots, N = ccl.roots_from_tgt(torch.from_numpy(np.array(tgt)), cap_n)
  np.testing.assert_array_equal(roots.numpy(), np.asarray(want_roots))
  np.testing.assert_array_equal(N.numpy(), np.asarray(want_N))
  T = rng.randint(-(1 << 31), 1 << 31, size=(B, K, cap_n),
                  dtype=np.int64).astype(np.int32)
  want_cc, want_p = ccl_pallas.plant_traced(L, want_roots, jnp.asarray(T),
                                            sx, sy)
  cc, painted = ccl.plant(torch.from_numpy(np.array(L)), roots,
                          torch.from_numpy(T) if K else None)
  np.testing.assert_array_equal(cc.numpy(), np.asarray(want_cc))
  assert painted.shape == (B, K, sy * sx)
  np.testing.assert_array_equal(painted.numpy(), np.asarray(want_p))


def _roots_cases():
  """name -> (vcg, roots width): N below the width (padded with n), N
  at it, N past it (ranks dropped), a 1 x 7 slice and B = 1."""
  yy, xx = np.indices((4, 4))
  board = labels_to_vcg(((yy + xx) % 2)[None])  # N = 16
  return {
    "below": (_v2_inputs(11), 512),
    "equal": (board, 16),
    "above": (_v2_inputs(12), 64),
    "1x7": (_v2_inputs(8, 2, 1, 7), 8),
    "B1": (_v2_inputs(13, 1), 512),
  }


@pytest.mark.parametrize("name", sorted(_roots_cases()))
def test_ccl_min_roots_matches_pallas_interpret(monkeypatch, name):
  """ccl_min_roots equals ccl_pallas.ccl_min_traced followed by
  ccl_pallas.roots_from_tgt: L, the roots and N (the full count where
  it passes the width, as the port's roots_from_tgt gives it)."""
  monkeypatch.setattr(ccl_pallas, "INTERPRET", True)
  vcg, cap = _roots_cases()[name]
  B, sy, sx = vcg.shape
  want_L, tgt = ccl_pallas.ccl_min_traced(
    jnp.asarray(vcg.reshape(B, -1)), sx, sy)
  want_roots, want_N = ccl_pallas.roots_from_tgt(tgt, cap)
  L, roots, N = ccl.ccl_min_roots(torch.from_numpy(vcg), cap)
  assert roots.dtype == N.dtype == torch.int32 and roots.shape == (B, cap)
  np.testing.assert_array_equal(L.numpy(), np.asarray(want_L))
  np.testing.assert_array_equal(roots.numpy(), np.asarray(want_roots))
  np.testing.assert_array_equal(N.numpy(), np.asarray(want_N))
  for got, want in zip((roots, N), ccl.roots_from_tgt(
      torch.from_numpy(np.array(tgt)), cap)):
    assert torch.equal(got, want)
  n_max = int(N.max())
  assert {"below": n_max < cap, "equal": n_max == cap,
          "above": n_max > cap}.get(name, True)
  if n_max < cap:
    assert int(roots[N.argmax(), -1]) == sy * sx


def test_ccl_min_roots_rejects_bad_inputs():
  vcg = torch.zeros((2, 4, 4), dtype=torch.int32)
  with pytest.raises(ValueError):
    ccl.ccl_min_roots(vcg.to(torch.int64), 8)
  with pytest.raises(ValueError):
    ccl.ccl_min_roots(vcg, 0)


@pytest.mark.parametrize("cap_n", [512, 300])
def test_ccl_paint_v2_matches_v1(cap_n):
  """test_jax_decode.test_ccl_v2_plant_matches_v1 for the port: the v2
  composition equals ccl_paint (a non-power-of-two table is padded)."""
  rng = np.random.RandomState(11)
  vcg = torch.from_numpy(_v2_inputs(11))
  T = torch.from_numpy(
    rng.randint(1, 1 << 20, size=(3, 1, cap_n)).astype(np.int32))
  for got, want in zip(ccl.ccl_paint_v2(vcg, T), ccl.ccl_paint(vcg, T)):
    assert torch.equal(got, want)


def test_pow2_cap_matches_reference():
  for n in (0, 1, 7, 8, 9, 300, 512, 513, 2048):
    assert ccl._pow2_cap(n) == ccl_pallas._pow2_cap(n)


def test_plant_misses_are_zero():
  """Ids that no root holds, the padding value n, and ids outside
  [0, n) plant 0 for cc and every channel."""
  n = 6
  L = torch.tensor([[[0, 2, 3], [6, -1, 9]]], dtype=torch.int32)
  roots = torch.tensor([[0, 3, 6, 6]], dtype=torch.int32)
  T = torch.tensor([[[10, 11, 12, 13], [20, 21, 22, 23]]],
                   dtype=torch.int32)
  cc, painted = ccl.plant(L, roots, T)
  assert cc.tolist() == [[0, 0, 1, 0, 0, 0]]
  assert painted.tolist() == [[[10, 0, 11, 0, 0, 0], [20, 0, 21, 0, 0, 0]]]
  assert L.numel() == n


def test_plant_rejects_bad_inputs():
  L = torch.zeros((2, 4, 4), dtype=torch.int32)
  roots = torch.zeros((2, 8), dtype=torch.int32)
  with pytest.raises(ValueError):
    ccl.plant(L.to(torch.int64), roots)
  with pytest.raises(ValueError):
    ccl.plant(L, roots[:1])
  with pytest.raises(ValueError):
    ccl.plant(L, torch.zeros((2, 0), dtype=torch.int32))
  with pytest.raises(ValueError):
    ccl.plant(L, roots, torch.zeros((2, 1, 4), dtype=torch.int32))
  with pytest.raises(ValueError):
    ccl.plant(L, roots, torch.zeros((2, 3, 8), dtype=torch.int32))
  with pytest.raises(ValueError):
    ccl.ccl_min(L[:, 0])
