"""The port's z splice (crackle_tpu_torch/operations.py) against
crackle_tpu.operations, byte for byte."""
import numpy as np
import pytest

import crackle_tpu as crackle
from crackle_tpu import operations as rops
from crackle_tpu_torch import codec as pcodec
from crackle_tpu_torch import operations as tops

from test_codec import random_volume


def chunks(vol, cuts):
  """vol split along z at cuts, each chunk Fortran-ordered."""
  edges = [0] + list(cuts) + [vol.shape[2]]
  return [np.asfortranarray(vol[:, :, a:b]) for a, b in zip(edges, edges[1:])]


def parts_of(name):
  """(parts for zstack, the stacked volume) of each case."""
  if name == "flat":
    vol = random_volume((9, 9, 8), 5, seed=31, smooth=4)
    return [crackle.compress(c) for c in chunks(vol, (3, 5))], vol
  if name == "flat u64":
    vol = random_volume((9, 7, 6), 4, seed=32, smooth=3).astype(np.uint64)
    vol = np.asfortranarray(vol + np.uint64(2) ** 40)
    return [crackle.compress(c) for c in chunks(vol, (2,))], vol
  if name == "pins":
    vol = random_volume((8, 8, 8), 3, seed=9, smooth=8)
    parts = [crackle.compress(c, allow_pins=1) for c in chunks(vol, (4,))]
    assert all(crackle.header(p).label_format == 2 for p in parts)
    return parts, vol
  if name == "markov":
    vol = random_volume((10, 9, 7), 4, seed=33, smooth=3)
    return [crackle.compress(c, markov_model_order=3)
            for c in chunks(vol, (3,))], vol
  if name == "C order":
    vol = random_volume((9, 8, 6), 4, seed=34, smooth=3)
    return [crackle.compress(np.ascontiguousarray(c))
            for c in chunks(vol, (1, 4))], np.ascontiguousarray(vol)
  if name == "arrays and bytes":
    vol = random_volume((9, 9, 8), 5, seed=35, smooth=4)
    a, b, c = chunks(vol, (2, 6))
    return [a, crackle.compress(b), None, c], vol
  if name == "one part":
    vol = random_volume((9, 9, 5), 5, seed=36, smooth=4)
    return [crackle.compress(vol, markov_model_order=2)], vol
  raise KeyError(name)


@pytest.mark.parametrize("name", ["flat", "flat u64", "pins", "markov",
                                  "C order", "arrays and bytes", "one part"])
def test_zstack_matches_reference(name):
  parts, vol = parts_of(name)
  got = tops.zstack(parts)
  assert got == rops.zstack(parts)
  np.testing.assert_array_equal(pcodec.decompress(got), vol)
  assert pcodec.header(got).fortran_order == vol.flags.f_contiguous
  if name not in ("pins", "markov", "one part"):
    assert got == crackle.compress(vol)


def test_zstack_rejects_mismatched_slices():
  a = crackle.compress(random_volume((9, 9, 3), 4, seed=1, smooth=2))
  b = crackle.compress(random_volume((9, 8, 3), 4, seed=2, smooth=2))
  for mod in (rops, tops):
    with pytest.raises(ValueError, match="same slice shape"):
      mod.zstack([a, b])


@pytest.mark.parametrize("flip", ["asfortranarray", "ascontiguousarray"])
def test_order_flips_match_reference(flip):
  vol = random_volume((7, 6, 4), 3, seed=3, smooth=2)
  for binary in (crackle.compress(vol),
                 crackle.compress(np.ascontiguousarray(vol))):
    assert getattr(tops, flip)(binary) == getattr(rops, flip)(binary)


# ---------------------------------------------------------------------------
# The rest of operations.py: edits, splits, synthesized streams, scalar
# operators and the functions that decode, against crackle_tpu.operations
# ---------------------------------------------------------------------------

def _pins_volume():
  """The condensed-pins volume of test_jax_decode.py:443-449."""
  rng = np.random.RandomState(9)
  vol = rng.randint(0, 4, size=(20, 18, 10)).astype(np.uint32)
  for _ in range(12):
    ax = rng.randint(0, 3)
    m = rng.rand(*vol.shape) < 0.6
    vol = np.where(m, np.roll(vol, 1, axis=ax), vol)
  return np.asfortranarray(vol)


# name -> (volume maker, compress options); "signed" is a stream that
# full() synthesizes (compress takes no signed labels)
STREAMS = {
  "flat u32": (lambda: random_volume((13, 11, 6), 5, seed=41, smooth=3), {}),
  "flat u64": (lambda: np.asfortranarray(
    random_volume((12, 10, 5), 4, seed=42, smooth=3).astype(np.uint64)
    + np.uint64(2) ** 40), {}),
  "C order": (lambda: np.ascontiguousarray(
    random_volume((11, 9, 5), 4, seed=43, smooth=3)), {}),
  "pins": (_pins_volume, {"allow_pins": 1}),
  "markov-3": (lambda: random_volume((14, 12, 5), 5, seed=44, smooth=4),
               {"markov_model_order": 3}),
  "one slice": (lambda: random_volume((12, 10, 1), 4, seed=45, smooth=2),
                {}),
  "empty": (lambda: np.zeros((6, 5, 3), np.uint32, order="F"), {}),
  "signed": (None, {}),
}


def stream_of(name):
  """(volume or None, crackle_tpu bytes) of a STREAMS entry."""
  make, opts = STREAMS[name]
  if make is None:
    return None, rops.full((6, 5, 3), -5, np.int32, order="F")
  vol = make()
  binary = crackle.compress(vol, **opts)
  assert (crackle.header(binary).label_format == 2) == (name == "pins")
  return vol, binary


def same_outcome(fn_ref, fn_port, *args, **kwargs):
  """Both calls return equal values (bytes, ints, tuples of them,
  mappings) or raise exceptions of the same type (by name: each package
  has its own FormatError)."""
  try:
    want = fn_ref(*args, **kwargs)
  except Exception as exc:  # the reference's error is the expectation
    with pytest.raises(Exception) as got:
      fn_port(*args, **kwargs)
    assert type(got.value).__name__ == type(exc).__name__
    return None
  got = fn_port(*args, **kwargs)
  assert type(got) is type(want)
  assert got == want
  return got


@pytest.fixture(params=["numpy", "torch"])
def engine(request, monkeypatch):
  """The port's codec on its host engine, or on the torch engine on the
  CPU (the device routes on the plain versions); the reference on its
  host engine."""
  from crackle_tpu import codec as rcodec
  monkeypatch.setattr(rcodec, "_ENGINE", "numpy")
  if request.param == "numpy":
    pcodec.set_engine("numpy")
  else:
    pcodec.set_engine("torch", device="cpu")
  yield request.param
  pcodec.set_engine("auto")


@pytest.mark.parametrize("name", list(STREAMS))
def test_min_max_refit_match_reference(name):
  _, binary = stream_of(name)
  for fn in ("min", "max", "refit"):
    same_outcome(getattr(rops, fn), getattr(tops, fn), binary)


@pytest.mark.parametrize("name", list(STREAMS))
def test_remap_matches_reference(name):
  """An in-place remap of every label, one that widens the stored width,
  a partial one with preserve_missing_labels, and one missing a label
  (KeyError in both)."""
  _, binary = stream_of(name)
  uniq = [int(u) for u in crackle.labels(binary)]
  cases = [
    ({u: (u * 3 + 1) % 251 for u in uniq}, False),
    ({u: u + 2 ** 35 for u in uniq}, False),
    ({uniq[0]: 7}, True),
    ({uniq[0]: 7}, len(uniq) == 1),
  ]
  for mapping, preserve in cases:
    same_outcome(rops.remap, tops.remap, binary, mapping,
                 preserve_missing_labels=preserve)


@pytest.mark.parametrize("name", list(STREAMS))
def test_mask_matches_reference(name):
  _, binary = stream_of(name)
  uniq = [int(u) for u in crackle.labels(binary)]
  for labels, value in ((uniq[:1], 0), (uniq[1:3], 9), ([10 ** 6], 0)):
    same_outcome(rops.mask, tops.mask, binary, labels, value=value)
    same_outcome(rops.mask_except, tops.mask_except, binary, labels,
                 value=value)


@pytest.mark.parametrize("name", list(STREAMS))
def test_renumber_matches_reference(name):
  """The renumbered bytes and the mapping dict, from 0 and from 5."""
  _, binary = stream_of(name)
  for start in (0, 5):
    same_outcome(rops.renumber, tops.renumber, binary, start=start)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32,
                                   np.uint64, np.int16])
@pytest.mark.parametrize("casting", ["unsafe", "no", "equiv", "same_kind",
                                     "safe"])
def test_astype_casting_rules_match_reference(dtype, casting):
  """astype's bytes, or the same exception type, under each casting
  rule, for the u32 volume whose labels fit u8."""
  _, binary = stream_of("flat u32")
  for order in ("K", "C", "F"):
    same_outcome(rops.astype, tops.astype, binary, dtype, order=order,
                 casting=casting)


@pytest.mark.parametrize("name", list(STREAMS))
def test_zsplit_and_zshatter_match_reference(name):
  """zsplit at each z and outside [0, sz) (ValueError in both), and
  zshatter; the pieces decode to the volume's slices. (The pieces of a
  markov stream keep its header's model order but not its model, in
  both packages, and do not decode.)"""
  vol, binary = stream_of(name)
  if name == "markov-3":
    vol = None
  sz = crackle.header(binary).sz
  for z in (-1, 0, sz // 2, sz - 1, sz):
    got = same_outcome(rops.zsplit, tops.zsplit, binary, z)
    if got is not None and vol is not None and got[0]:
      np.testing.assert_array_equal(pcodec.decompress(got[0]),
                                    vol[:, :, :z])
  got = same_outcome(rops.zshatter, tops.zshatter, binary)
  if got is not None and vol is not None:
    for z, part in enumerate(got):
      np.testing.assert_array_equal(pcodec.decompress(part),
                                    vol[:, :, z:z + 1])


@pytest.mark.parametrize("fill", [0, 1, 7, 300, 2 ** 40, -5])
@pytest.mark.parametrize("order", ["C", "F"])
def test_full_zeros_ones_match_reference(fill, order):
  shape = (7, 6, 4)
  for dtype in (None, np.uint64):
    got = same_outcome(rops.full, tops.full, shape, fill, dtype, order)
  assert tops.EMPTY_SLICE_CRACK_CODE == rops.EMPTY_SLICE_CRACK_CODE
  if fill >= 0:
    np.testing.assert_array_equal(pcodec.decompress(got),
                                  np.full(shape, fill, np.uint64))
  for fn in ("zeros", "ones"):
    same_outcome(getattr(rops, fn), getattr(tops, fn), shape, np.uint16,
                 order)


@pytest.mark.parametrize("op, scalars", [
  ("add_scalar", [0, 3, 2 ** 33]), ("subtract_scalar", [0, 1]),
  ("multiply_scalar", [1, 5, 2 ** 30]), ("floordiv_scalar", [1, 2, 7]),
  ("truediv_scalar", [1, 2])])
@pytest.mark.parametrize("name", ["flat u32", "flat u64", "one slice"])
def test_scalar_operators_match_reference(op, scalars, name):
  _, binary = stream_of(name)
  for scalar in scalars:
    same_outcome(getattr(rops, op), getattr(tops, op), binary, scalar)


@pytest.mark.parametrize("name", ["flat u32", "flat u64", "C order", "pins",
                                  "markov-3", "one slice", "empty"])
def test_recompress_matches_reference(engine, name):
  """recompress after a merging remap: decoded and encoded again through
  the port's codec (on the CPU device under 'torch'), bytes equal."""
  _, binary = stream_of(name)
  uniq = [int(u) for u in crackle.labels(binary)]
  merged = rops.remap(binary, {u: u // 2 for u in uniq})
  for b, kw in ((binary, {}), (merged, {}), (merged, {"allow_pins": True}),
                (binary, {"memory_target": 1})):
    same_outcome(rops.recompress, tops.recompress, b, **kw)


@pytest.mark.parametrize("name", ["flat u32", "flat u64", "C order", "pins",
                                  "markov-3", "one slice", "empty"])
def test_array_equal_matches_reference(engine, name):
  """Against itself, its other encodings (pins, markov, C order, a
  renumbering), a masked copy and another shape."""
  vol, binary = stream_of(name)
  uniq = [int(u) for u in crackle.labels(binary)]
  others = [binary, crackle.compress(vol), crackle.compress(
    vol, markov_model_order=2), crackle.compress(np.ascontiguousarray(vol)),
    rops.mask(binary, uniq[:1], value=uniq[-1] + 1),
    rops.renumber(binary, start=1)[0],
    crackle.compress(np.asfortranarray(vol[:, :, :1]))]
  for other in others:
    same_outcome(rops.array_equal, tops.array_equal, binary, other)
    same_outcome(rops.structure_equal, tops.structure_equal, binary, other)


def test_edits_of_zero_size_volumes_match_reference(engine):
  """Streams of no voxels: each function returns what the reference
  returns or raises the same exception type."""
  for shape in ((0, 0, 0), (8, 8, 0), (0, 5, 3)):
    binary = crackle.compress(np.zeros(shape, np.uint32, order="F"))
    for fn in ("min", "max", "renumber", "zshatter", "recompress",
               "connected_components", "mode_pooling_2x2x1", "contacts"):
      same_outcome(getattr(rops, fn), getattr(tops, fn), binary)
    for fn in ("array_equal", "structure_equal"):
      same_outcome(getattr(rops, fn), getattr(tops, fn), binary, binary)
    for c in (4, 6):
      same_outcome(rops.voxel_connectivity_graph,
                   tops.voxel_connectivity_graph, binary, c)


def test_reference_keywords_are_taken():
  """decompress_shard(..., mesh=None) and CrackleDeviceArray(binary,
  parallel=0) take the reference's keywords."""
  from crackle_tpu.parallel import multihost as rmh
  import crackle_tpu_torch as ct
  from crackle_tpu_torch.parallel import multihost as tmh
  vol = random_volume((4, 4, 4), 3, seed=5, smooth=1)
  binary = crackle.compress(vol)
  want, wwin = rmh.decompress_shard(binary, 1, 0, mesh=None)
  got, gwin = tmh.decompress_shard(binary, 1, 0, mesh=None)
  assert gwin == wwin == (0, 4)
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(got, vol)
  arr = ct.CrackleDeviceArray(binary, "cpu", parallel=0)
  assert arr.parallel == 0
  arr = ct.CrackleDeviceArray(binary, device="cpu", parallel=3)
  assert arr.parallel == 3
  np.testing.assert_array_equal(arr[:, :, :].numpy(), vol)
