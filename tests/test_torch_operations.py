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
