"""The window-decode entry points on the CPU against the reference: the
split of long slices into chain-aligned pieces, decode_window_ccl,
decode_window_device (the in-kernel paint and the gather paint past
PAINT_CAP_N components), decode_window with label= masks, and
codec.decompress under set_engine('torch'). Every comparison is exact."""
import logging

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import crackle_tpu as crackle
from crackle_tpu.kernels import ccl_pallas
from crackle_tpu.kernels import decode as jdec
from crackle_tpu.kernels import engine as jeng
from crackle_tpu.ops.ccl import connected_components_slice
import crackle_tpu_torch as ct
from crackle_tpu_torch import codec as pcodec
from crackle_tpu_torch.kernels import ccl as pccl
from crackle_tpu_torch.kernels import decode as pdec
from crackle_tpu_torch.kernels import engine as peng

from test_jax_decode import random_volume

INPUTS = ("packed", "nbytes", "nodes", "n_chains")


def islands(pitch: int, sx: int = 48):
  """3x3 islands on background 1 (tests/test_jax_decode.py:473-481, at
  sx 48), each island's boundary its own chain; at an x pitch of 4
  neighbours stand one pixel apart, so pieces set different bits of one
  pixel. At sx 96 and pitch 4 a slice holds 1,932 codepoints."""
  vol = np.ones((sx, 40, 3), np.uint32)
  k = 2
  for x0 in range(1, sx - 3, pitch):
    for y0 in range(1, 37, 6):
      for z in range(3):
        vol[x0:x0 + 3, y0:y0 + 3, z] = k
        k += 1
  return np.asfortranarray(vol)


def nuclei_volume(sx: int, sy: int, sz: int, seed: int = 7, pitch: int = 24):
  """Nucleus-like ellipsoids on background 0, the long-slice volume of
  chip_smoke.py at any size: on a jittered pitch-pixel grid, every third
  slice from z = -5, a cell is skipped with probability 0.25, else an
  ellipsoid of xy radius r in [6, 10] and z half-extent hz in [2, 5]
  paints a new label into the background pixels of the disc of radius
  r * sqrt(1 - ((z - zc) / (hz + 0.5))^2) on each slice it spans."""
  rng = np.random.RandomState(seed)
  vol = np.zeros((sz, sy, sx), np.uint32)
  label = 0
  for z0 in range(-5, sz, 3):
    for gy in range(0, sy, pitch):
      for gx in range(0, sx, pitch):
        if rng.rand() < 0.25:
          continue
        r = rng.randint(6, 11)
        hz = rng.randint(2, 6)
        cx = gx + pitch // 2 + rng.randint(-1, 2)
        cy = gy + pitch // 2 + rng.randint(-1, 2)
        zc = z0 + rng.randint(0, 3)
        label += 1
        y0, y1 = max(cy - r, 0), min(cy + r + 1, sy)
        x0, x1 = max(cx - r, 0), min(cx + r + 1, sx)
        d2 = ((np.arange(y0, y1) - cy)[:, None] ** 2
              + (np.arange(x0, x1) - cx)[None, :] ** 2)
        for z in range(max(zc - hz, 0), min(zc + hz + 1, sz)):
          box = vol[z, y0:y1, x0:x1]
          box[(d2 <= r * r * (1 - ((z - zc) / (hz + 0.5)) ** 2))
              & (box == 0)] = label
  return np.asfortranarray(vol.transpose(2, 1, 0))


def checkerboard(shape=(64, 64, 2), a=7, b=9, dtype=np.uint32):
  """Every pixel its own component: 4,096 a 64 x 64 slice, past
  PAINT_CAP_N, and one crack chain through the whole slice."""
  x, y, z = np.indices(shape)
  return np.asfortranarray(np.where((x + y + z) % 2, a, b).astype(dtype))


def pins_volume():
  """The condensed-pins volume of test_jax_decode.py:443-449."""
  rng = np.random.RandomState(9)
  vol = rng.randint(0, 4, size=(20, 18, 10)).astype(np.uint32)
  for _ in range(12):
    ax = rng.randint(0, 3)
    m = rng.rand(*vol.shape) < 0.6
    vol = np.where(m, np.roll(vol, 1, axis=ax), vol)
  return np.asfortranarray(vol)


def host_ccl(vol, z):
  sx, sy = vol.shape[:2]
  return connected_components_slice(
    np.ascontiguousarray(vol[:, :, z].T).ravel(), sx, sy)


@pytest.fixture
def small_cap(monkeypatch):
  """MAX_DEVICE_CAP at 1024 codepoints in both packages, so slices of
  islands(4, 96) take the split (two pieces each)."""
  monkeypatch.setattr(jeng, "MAX_DEVICE_CAP", 1024)
  monkeypatch.setattr(peng, "MAX_DEVICE_CAP", 1024)


@pytest.fixture
def engine():
  """Selects the port's decode engine for one test and restores auto."""
  yield pcodec.set_engine
  pcodec.set_engine("auto")


@pytest.mark.parametrize("pitch", [6, 4])
@pytest.mark.parametrize("cps", [64, 128, 512])
def test_split_matches_reference_and_host(monkeypatch, pitch, cps):
  """prepare_split_inputs gives the reference's arrays and piece_z; the
  split cc and N equal the reference's _decode_ccl_split and the host
  CCL; the merged VCG equals the unsplit replay of each slice, which an
  OR merge of the pieces' bits gives and the reference's max merge does
  not where islands stand one pixel apart."""
  vol = islands(pitch)
  binary = crackle.compress(vol)
  want, want_z = jeng.prepare_split_inputs(binary, 0, 3, max_cps=cps)
  got, piece_z = peng.prepare_split_inputs(binary, 0, 3, max_cps=cps)
  for k in INPUTS:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  np.testing.assert_array_equal(piece_z, want_z)
  assert len(piece_z) > 3

  head = got["head"]
  perm = head.crack_format == ct.CrackFormat.PERMISSIBLE
  t = ct.params_from_jax(got, device="cpu", piece_z=piece_z)
  args = [t[k] for k in INPUTS] + [t["piece_z"], 3]
  vcg = pdec.decode_pieces_to_vcg(*args, head.sx, head.sy, perm)
  whole = ct.params_from_jax(peng.prepare_slice_inputs(binary, 0, 3),
                             device="cpu")
  unsplit = pdec._vcg_for_ccl(*(whole[k] for k in INPUTS), head.sx,
                              head.sy, perm)
  assert torch.equal(vcg, unsplit)

  # the reference's merge of the same pieces' presence bits
  v = np.asarray(jdec.decode_slices_to_vcg(
    *(jnp.asarray(want[k]) for k in INPUTS), sx=head.sx, sy=head.sy,
    permissible=perm))
  pres = v if perm else v ^ 0b1111
  by_max = np.zeros((3, head.sx * head.sy), pres.dtype)
  by_or = by_max.copy()
  np.maximum.at(by_max, want_z, pres)
  np.bitwise_or.at(by_or, want_z, pres)
  np.testing.assert_array_equal(vcg.reshape(3, -1).numpy() ^ (
    0 if perm else 0b1111), by_or)
  # the merged pixels (of 5,760) where a max merge differs from an OR
  lost = {4: {64: 135, 128: 63, 512: 9}}.get(pitch, {}).get(cps, 0)
  assert int((by_max != by_or).sum()) == lost

  cc, N = pdec.decode_pieces_to_ccl(*args, head.sx, head.sy, perm)
  monkeypatch.setattr(jeng, "SPLIT_TARGET_CPS", cps)
  wcc, wN, _ = jeng._decode_ccl_split(binary, 0, 3)
  np.testing.assert_array_equal(cc.numpy(), np.asarray(wcc))
  np.testing.assert_array_equal(N.numpy(), np.asarray(wN))
  for z in range(3):
    hcc, hn = host_ccl(vol, z)
    np.testing.assert_array_equal(cc[z].numpy(), hcc.astype(np.int32))
    assert int(N[z]) == hn


def test_windows_outside_the_stream_raise():
  binary = crackle.compress(random_volume((8, 8, 3), 3, 1, 0))
  for fn in (ct.decode_window, ct.decode_window_device,
             ct.decode_window_ccl_device, ct.decode_window_ccl):
    for z0, z1 in [(2, 4), (-1, 2), (1, 1)]:
      with pytest.raises(ValueError, match="outside"):
        fn(binary, z0, z1, device="cpu")


def test_slice_rows_needs_slice_order():
  ids = torch.arange(6, dtype=torch.int32).reshape(3, 2)
  rows = pdec.slice_rows(ids, torch.tensor([0, 0, 2]), 3)
  np.testing.assert_array_equal(
    rows.numpy(), [[0, 1, 2, 3], [-1, -1, -1, -1], [4, 5, -1, -1]])
  with pytest.raises(ValueError, match="slice order"):
    pdec.slice_rows(ids, torch.tensor([1, 0, 2]), 3)


def test_decode_window_ccl_through_the_split(small_cap):
  """With MAX_DEVICE_CAP at 1024 in both packages, decode_window_ccl
  takes the split; a flipped stored CRC names the same z in both."""
  vol = islands(4, 96)
  binary = crackle.compress(vol)
  assert not peng._device_cap_ok(peng.prepare_slice_inputs(binary, 0, 3))
  wcc, wN = jeng.decode_window_ccl(binary, 0, 3, check_crcs=True)
  cc, N = ct.decode_window_ccl(binary, 0, 3, check_crcs=True, device="cpu")
  assert isinstance(cc, np.ndarray) and isinstance(N, np.ndarray)
  np.testing.assert_array_equal(cc, wcc)
  np.testing.assert_array_equal(N, wN)
  cc, N = ct.decode_window_ccl(binary, 1, 3, device="cpu")
  np.testing.assert_array_equal(cc, wcc[1:])

  bad = bytearray(binary)
  bad[-(3 - 1) * 4] ^= 0x10  # slice 1's stored word
  bad = bytes(bad)
  with pytest.raises(crackle.FormatError) as want:
    jeng.decode_window_ccl(bad, 0, 3, check_crcs=True)
  with pytest.raises(ct.FormatError) as got:
    ct.decode_window_ccl(bad, 0, 3, check_crcs=True, device="cpu")
  assert "z=1 " in str(want.value) and "z=1 " in str(got.value)
  assert str(got.value) == str(want.value)
  ct.decode_window_ccl(bad, 0, 3, check_crcs=False, device="cpu")


# (name, volume maker, compress options)
VOLUMES = {
  "checkerboard": (checkerboard, {}),
  "u8": (lambda: random_volume((20, 16, 5), 9, 7, 4, np.uint8), {}),
  "u32 C order": (lambda: np.ascontiguousarray(
    random_volume((21, 17, 4), 6, 13, 5)), {}),
  "u64": (lambda: np.asfortranarray(random_volume(
    (20, 16, 4), 9, 7, 4).astype(np.uint64) + np.uint64(1 << 40)), {}),
  "markov-3": (lambda: random_volume((24, 20, 5), 6, 24, 5),
               {"markov_model_order": 3}),
  "pins": (pins_volume, {"allow_pins": 1}),
}


@pytest.mark.parametrize("name", list(VOLUMES))
def test_decode_window_matches_reference(monkeypatch, name):
  """decode_window and decode_window_device against the reference's
  (Pallas in interpret mode, so that both take the same paint and
  decline the same windows) on a window, and against the volume whole;
  label= masks of a present and an absent label."""
  make, opts = VOLUMES[name]
  vol = make()
  binary = crackle.compress(vol, **opts)
  head = crackle.header(binary)
  assert (head.label_format == 2) == (name == "pins")
  sz = vol.shape[2]
  got = ct.decode_window(binary, 0, sz, device="cpu")
  np.testing.assert_array_equal(got, vol)
  assert got.dtype == vol.dtype and got.flags.f_contiguous == (
    head.fortran_order)

  present = int(vol[3, 2, 1])
  for label in (present, int(vol.max()) + 1):
    got = ct.decode_window(binary, 1, sz, label=label, device="cpu")
    want = jeng.decode_window(binary, 1, sz, label=label)
    if name == "pins":  # single-label pins queries stay on the host
      assert got is None and want is None
      continue
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vol[:, :, 1:] == label)

  monkeypatch.setattr(ccl_pallas, "INTERPRET", True)
  got = ct.decode_window(binary, 1, sz, device="cpu")
  want = jeng.decode_window(binary, 1, sz)
  np.testing.assert_array_equal(got, want)
  assert got.dtype == want.dtype
  assert got.flags.f_contiguous == want.flags.f_contiguous
  res = ct.decode_window_device(binary, 1, sz, device="cpu")
  wres = jeng.decode_window_device(binary, 1, sz)
  for a, b in zip(res[:3], wres[:3]):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_gather_paint_past_paint_cap_n(monkeypatch):
  """The 64 x 64 checkerboard's 4,096 components a slice take
  decode_slices_full: its labels, cc and N equal the reference's, and
  its paint_keys and paint_labels_u32 equal theirs on the same cc."""
  vol = checkerboard()
  binary = crackle.compress(vol)
  uniq, cum, keys = peng._flat_label_tables(crackle.header(binary), binary)
  assert int((cum[1:] - cum[:-1]).min()) == 4096 > pccl.PAINT_CAP_N
  inputs = jeng.prepare_slice_inputs(binary, 0, 2)
  t = ct.params_from_jax(inputs, device="cpu")
  off, k64, u32 = peng._gather_tables(uniq, cum, keys, 0, 2, "cpu")
  labels, cc, N = ct.decode_slices_full(
    *(t[k] for k in INPUTS), off, k64, u32, sx=64, sy=64,
    permissible=bool(inputs["head"].crack_format))
  want = jdec.decode_slices_full(
    *(jnp.asarray(inputs[k]) for k in INPUTS),
    jnp.asarray(cum[:2].astype(np.int32)), jnp.asarray(keys.astype(np.int32)),
    jnp.asarray(uniq.astype(np.uint32)), sx=64, sy=64,
    permissible=bool(inputs["head"].crack_format))
  assert labels.dtype == torch.uint32
  for a, b in zip((labels, cc, N), want):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
  wk = jdec.paint_keys(jnp.asarray(cc.numpy()), jnp.asarray(N.numpy()),
                       jnp.asarray(cum[:2].astype(np.int32)),
                       jnp.asarray(keys.astype(np.int32)))
  np.testing.assert_array_equal(pdec.paint_keys(cc, off, k64).numpy(), wk)
  np.testing.assert_array_equal(
    pdec.paint_labels_u32(cc, off, k64, u32).numpy(),
    np.asarray(jdec.paint_labels_u32(
      jnp.asarray(cc.numpy()), jnp.asarray(cum[:2].astype(np.int32)),
      jnp.asarray(keys.astype(np.int32)),
      jnp.asarray(uniq.astype(np.uint32)))))


@pytest.mark.parametrize("name", ["islands", "nuclei"])
def test_decode_window_through_the_split(small_cap, name):
  """Long slices (MAX_DEVICE_CAP at 1024 in both packages):
  decode_window_device declines, decode_window takes the split and the
  gather paint, and label= masks take it too, as in the reference."""
  vol = islands(4, 96) if name == "islands" else nuclei_volume(120, 96, 3)
  binary = crackle.compress(vol)
  assert not peng._device_cap_ok(peng.prepare_slice_inputs(binary, 0, 3))
  assert ct.decode_window_device(binary, 0, 3, device="cpu") is None
  assert jeng.decode_window_device(binary, 0, 3) is None
  for z0, z1 in [(0, 3), (2, 3)]:
    got = ct.decode_window(binary, z0, z1, device="cpu")
    np.testing.assert_array_equal(got, vol[:, :, z0:z1])
    np.testing.assert_array_equal(got, jeng.decode_window(binary, z0, z1))
  for label in (int(vol[4, 4, 1]), 1, 10 ** 6):
    got = ct.decode_window(binary, 0, 3, label=label, device="cpu")
    np.testing.assert_array_equal(got, vol == label)
    np.testing.assert_array_equal(
      got, jeng.decode_window(binary, 0, 3, label=label))


@pytest.mark.parametrize("case", ["u64 long slices", "one long chain",
                                  "pins long slices", "markov long slices"])
def test_declines_match_reference(monkeypatch, caplog, case):
  """The windows both packages send to the host decoder, with the reason
  logged: u64 flat long slices (label=None), a single chain longer than
  the piece limit (2-label noise: one chain holds most of a slice), pins
  and markov streams with long slices (past 512 codepoints here)."""
  monkeypatch.setattr(ccl_pallas, "INTERPRET", True)
  monkeypatch.setattr(jeng, "MAX_DEVICE_CAP", 512)
  monkeypatch.setattr(peng, "MAX_DEVICE_CAP", 512)
  vol, opts, label_ok = {
    "u64 long slices": (islands(4).astype(np.uint64) << np.uint64(33), {},
                        True),
    "one long chain": (random_volume((40, 40, 3), 2, 3, 0), {}, False),
    "pins long slices": (pins_volume(), {"allow_pins": 1}, False),
    "markov long slices": (islands(4), {"markov_model_order": 3}, False),
  }[case]
  binary = crackle.compress(np.asfortranarray(vol), **opts)
  assert jeng.decode_window(binary, 0, 3) is None
  assert ct.decode_window(binary, 0, 3, device="cpu") is None
  assert "decode_window: declined" in caplog.text
  label = int(vol[4, 4, 1])
  want = jeng.decode_window(binary, 0, 3, label=label)
  got = ct.decode_window(binary, 0, 3, label=label, device="cpu")
  assert (want is not None) == (got is not None) == label_ok
  if label_ok:
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["checkerboard", "u64", "markov-3", "pins"])
def test_decompress_under_the_torch_engine(engine, caplog, name):
  """codec.decompress under set_engine('torch') on the CPU equals it
  under 'numpy', whole, on a window and as a mask, and no window falls
  back to the host decoder."""
  make, opts = VOLUMES[name]
  vol = make()
  binary = pcodec.compress(vol, **opts)
  label = int(vol[3, 2, 1])
  engine("numpy")
  want = [pcodec.decompress(binary), pcodec.decompress_range(binary, 1, 3),
          pcodec.decompress(binary, label=label)]
  engine("torch", device="cpu")
  assert pcodec.get_engine() == "torch"
  with caplog.at_level(logging.WARNING):
    got = [pcodec.decompress(binary), pcodec.decompress_range(binary, 1, 3)]
  assert "declined" not in caplog.text
  got.append(pcodec.decompress(binary, label=label))
  for a, b in zip(got, want):
    assert a.dtype == b.dtype and a.flags.f_contiguous == b.flags.f_contiguous
    np.testing.assert_array_equal(a, b)
  np.testing.assert_array_equal(got[0], vol)


def test_decompress_falls_back_where_the_engine_declines(engine, caplog,
                                                        small_cap):
  """A window the torch engine declines (a single chain past the piece
  limit) logs the reason and decodes on the host."""
  vol = random_volume((40, 40, 3), 2, 3, 0)
  binary = pcodec.compress(vol)
  engine("torch", device="cpu")
  np.testing.assert_array_equal(pcodec.decompress(binary), vol)
  assert "decompress: declined" in caplog.text


def test_set_engine_and_devices(engine):
  with pytest.raises(ValueError, match="auto|numpy|torch"):
    engine("jax")
  assert pcodec.get_engine() == "auto"
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present")
  binary = pcodec.compress(random_volume((8, 8, 2), 3, 1, 0))
  for fn in (ct.decode_window, ct.decode_window_device, ct.decode_window_ccl):
    with pytest.raises(RuntimeError, match="CUDA"):
      fn(binary, 0, 2)
  engine("torch")
  with pytest.raises(RuntimeError, match="CUDA"):
    pcodec.decompress(binary)
