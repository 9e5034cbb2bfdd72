"""The condensed-pins encoder of the port (ops/pins.py, the pins branch
of codec.compress and kernels/encode.py encode_pins_device) on the CPU:
its bytes against the reference's compress(..., allow_pins=1) on seeded
volumes from u8 to u64, its column scan and previous-column dedup
against the reference's loop, each component's choice of pin against
the reference solver's scan, and the native pick order against the
robin-hood emulation."""
import numpy as np
import pytest
import torch

import crackle_tpu as crackle
from crackle_tpu.ops import pins as ref_pins
from crackle_tpu.ops.ccl import connected_components as ref_ccl
from crackle_tpu_torch import codec
from crackle_tpu_torch import native
from crackle_tpu_torch.kernels import encode as tenc
from crackle_tpu_torch.kernels import engine as teng
from crackle_tpu_torch.ops import pins

_SIGNED = {2: np.int16, 4: np.int32, 8: np.int64}


def smooth_volume(shape, nl, seed, smooth, dtype=np.uint32, p=0.7):
  """Random labels rolled along random axes: long vertical runs of few
  labels, so that allow_pins=1 picks condensed pins."""
  rng = np.random.RandomState(seed)
  a = rng.randint(0, nl, size=shape).astype(np.uint64)
  for _ in range(smooth):
    axis = rng.randint(0, 3)
    a = np.where(rng.rand(*shape) < p, np.roll(a, 1, axis=axis), a)
  if dtype == np.uint64:
    a = a * np.uint64((1 << 40) + 7)  # labels past 32 bits
  return np.asfortranarray(a.astype(dtype))


def dedup_volume():
  """Columns of one row whose runs the previous-column dedup skips (a
  run inside, or equal to, the one before), replaces (a run holding the
  one before) and keeps (two columns apart), and a streak of columns
  that all fit the column before, where skips alternate."""
  A, B = 1, 2
  vol = np.full((12, 2, 8), B, np.uint32)
  spans = [(0, 7), (1, 3), (0, 7), (0, 7), (2, 4), (0, 7), (3, 4), (3, 4),
           (3, 4), (3, 4), (1, 6), (0, 7)]
  for x, (z0, z1) in enumerate(spans):
    vol[x, 0, z0:z1 + 1] = A
  vol[5, 0, 1] = B  # two runs of A in column 5
  vol[:, 1, :] = vol[::-1, 0, :]
  return np.asfortranarray(vol)


def many_pins_volume(dtype=np.uint32):
  """One label over most of each slice, so that every column's pin
  crosses the same component, with holes of others that break the
  columns at random depths."""
  rng = np.random.RandomState(17)
  vol = np.full((20, 18, 12), 5, np.uint64)
  holes = rng.rand(*vol.shape) < 0.06
  vol[holes] = rng.randint(6, 9, int(holes.sum()))
  return np.asfortranarray(vol.astype(dtype))


BARE_LABEL = 3


def bare_slices_volume(dtype=np.uint32):
  """Slices of the background label (the label of the most pins) alone,
  which hold no pin and no single, between smooth ones."""
  vol = smooth_volume((16, 14, 9), 3, 24, 50) + 1
  vol[:, :, 3] = BARE_LABEL
  vol[:, :, 7] = BARE_LABEL
  return np.asfortranarray(vol.astype(dtype))


CASES = [
  ("smooth", ((20, 18, 10), 4, 9, 12), np.uint8),
  ("smooth", ((33, 17, 9), 5, 31, 40), np.uint16),
  ("smooth", ((40, 36, 16), 4, 3, 50), np.uint32),
  ("smooth", ((24, 31, 7), 3, 8, 40), np.uint64),
  ("smooth", ((2, 3, 2), 2, 4, 8), np.uint32),
  ("dedup", None, np.uint32),
  ("many_pins", None, np.uint16),
  ("many_pins", None, np.uint64),
  ("bare_slices", None, np.uint8),
  ("bare_slices", None, np.uint32),
]


def case_volume(kind, args, dtype):
  if kind == "smooth":
    return smooth_volume(*args, dtype=dtype)
  if kind == "dedup":
    return dedup_volume().astype(dtype, order="F")
  if kind == "many_pins":
    return many_pins_volume(dtype)
  return bare_slices_volume(dtype)


def as_tensor(vol):
  """An unsigned numpy volume as a tensor of its dtype (CPU)."""
  k = vol.dtype.itemsize
  if k == 1:
    return torch.from_numpy(vol)
  unsigned = {2: torch.uint16, 4: torch.uint32, 8: torch.uint64}
  return torch.from_numpy(vol.view(_SIGNED[k])).view(unsigned[k])


@pytest.mark.parametrize("kind,args,dtype", CASES)
def test_pins_bytes_match_reference(kind, args, dtype):
  """The host path (numpy), the device path on the CPU (a tensor, and
  numpy through encode_pins_device) and the Python pick all write the
  reference's bytes."""
  vol = case_volume(kind, args, dtype)
  want = crackle.compress(vol, allow_pins=1)
  assert codec.header(want).label_format == 2
  assert codec.compress(vol, allow_pins=1) == want
  assert codec.compress(as_tensor(vol), allow_pins=1) == want
  assert tenc.encode_pins_device(vol, device="cpu") == want
  c = np.ascontiguousarray(vol)
  assert tenc.encode_pins_device(c, fortran_order=False, device="cpu") == \
    crackle.compress(c, allow_pins=1)


@pytest.mark.parametrize("kind,args,dtype", CASES[:4] + CASES[6:7])
def test_python_pick_matches_native(monkeypatch, kind, args, dtype):
  vol = case_volume(kind, args, dtype)
  got = codec.compress(vol, allow_pins=1)
  monkeypatch.setattr(native, "pins_pick", lambda *a: None)
  assert codec.compress(vol, allow_pins=1) == got


@pytest.mark.parametrize("kind,args,dtype", CASES[1:3] + CASES[5:6])
def test_optimal_solver_and_manual_bgcolor_match_reference(kind, args,
                                                           dtype):
  vol = case_volume(kind, args, dtype)
  assert codec.compress(vol, allow_pins=2) == \
    crackle.compress(vol, allow_pins=2)
  for bg in (0, int(vol.max())):
    assert codec.compress(as_tensor(vol), allow_pins=1, bgcolor=bg) == \
      crackle.compress(vol, allow_pins=1, bgcolor=bg)


def _reference_columns(vol):
  sx, sy, sz = vol.shape
  flat = vol.ravel(order="F")
  cc, _, _ = ref_ccl(flat, sx, sy, sz)
  return ref_pins.extract_columns(flat, cc, sx, sy, sz), cc


def _port_columns(vol):
  sx, sy, sz = vol.shape
  lab = np.ascontiguousarray(vol.ravel(order="F"))
  lab = lab.view(_SIGNED.get(lab.dtype.itemsize, lab.dtype))
  return pins.extract_columns(torch.from_numpy(lab).reshape(sz, sx * sy),
                              sx, sz)


@pytest.mark.parametrize("kind,args,dtype", CASES)
def test_columns_match_reference_loop(kind, args, dtype):
  """Every label's candidate pins, in list order, and the labels in the
  order of their first run, as the reference's loop leaves them."""
  vol = case_volume(kind, args, dtype)
  want, _ = _reference_columns(vol)
  cols = _port_columns(vol)
  sx = vol.shape[0]
  col, zs, ze = (t.numpy() for t in (cols.col, cols.z_s, cols.z_e))
  got = {}
  for j, label in enumerate(cols.labels):
    got[label] = [(int(col[i] % sx), int(col[i] // sx), int(zs[i]),
                   int(ze[i])) for i in range(cols.seg[j], cols.seg[j + 1])]
  assert list(got) == list(want)
  for label, lst in want.items():
    assert got[label] == [(p.x, p.y, p.z_s, p.z_e) for p in lst]


def test_dedup_skips_replaces_and_alternates():
  """The dedup volume's label 1 in row 0: column 1 lies inside column 0
  (skipped); 2 is two columns from the state (kept); 3 equals 2
  (skipped); 4 is two columns from the state (kept); 5's two runs fit
  neither way (kept); along the streak of equal runs 6-9 the skips
  alternate (6 and 8 skipped); 10 holds 9 and 11 holds 10 (each
  replaces the one before)."""
  vol = dedup_volume()
  cols = _port_columns(vol)
  j = cols.labels.index(1)
  sl = slice(int(cols.seg[j]), int(cols.seg[j + 1]))
  got = [(int(c), int(a), int(b)) for c, a, b in zip(
    cols.col[sl].numpy(), cols.z_s[sl].numpy(), cols.z_e[sl].numpy())]
  row0 = [(0, 0, 7), (2, 0, 7), (4, 2, 4), (5, 0, 0), (5, 2, 7), (7, 3, 4),
          (11, 0, 7)]
  assert [g for g in got if g[0] < 12] == row0
  want, _ = _reference_columns(vol)
  assert [(p.x, p.z_s, p.z_e) for p in want[1] if p.y == 0] == row0


def _reference_choices(vol):
  """Each component's chosen pin by the reference solver's scan over its
  candidates (pins.hpp:328-336): the last one deeper than the first."""
  want, cc = _reference_columns(vol)
  out = {}
  for label, plist in want.items():
    cands = {}
    for i, p in enumerate(plist):
      for c in p.ccids:
        cands.setdefault(int(c), []).append(i)
    for c, idx in cands.items():
      best = plist[idx[0]]
      for i in idx[1:]:
        if plist[i].depth > plist[idx[0]].depth:
          best = plist[i]
      out[c] = (label, best.x, best.y, best.z_s, best.z_e)
  return out, int(cc.max()) + 1


@pytest.mark.parametrize("kind,args,dtype", CASES)
def test_cover_choice_matches_the_reference_scan(kind, args, dtype):
  vol = case_volume(kind, args, dtype)
  want, n_total = _reference_choices(vol)
  sx, sy, sz = vol.shape
  flat = vol.ravel(order="F")
  cc, _, _ = ref_ccl(flat, sx, sy, sz)
  cols = _port_columns(vol)
  cct = torch.from_numpy(cc.astype(np.int64)).reshape(sz, sx * sy)
  pin, comp = pins._pairs(cols, cct, sx * sy)
  choice = pins.cover_choice(cols, pin, comp, n_total).numpy()
  label = np.repeat(cols.labels, np.diff(cols.seg))
  got = {c: (int(label[k]), int(cols.col[k] % sx),
             int(cols.col[k] // sx), int(cols.z_s[k]), int(cols.z_e[k]))
         for c, k in enumerate(choice)}
  assert got == want
  if kind == "many_pins":
    assert max(np.bincount(comp.numpy())) >= 200


def test_bare_slices_hold_no_pin():
  vol = bare_slices_volume()
  binary = codec.compress(vol, allow_pins=1)
  assert binary == crackle.compress(vol, allow_pins=1)
  head = codec.header(binary)
  pl, _, si, _, bg32, _ = teng._pins_device_tables(head, binary, 0, head.sz)
  assert bg32 == BARE_LABEL
  for z in (3, 7):
    assert (pl[z] < 0).all() and (si[z] < 0).all()


@pytest.mark.parametrize("seed", range(6))
def test_native_pick_matches_rh_set(monkeypatch, seed):
  """Random universes (up to a few thousand components, so that the
  tables grow, rehash and halve their info increments) and choices."""
  rng = np.random.RandomState(seed)
  uni, uoff, coff, cids = [], [0], [0], []
  n_total = 0
  choice = []
  for _ in range(rng.randint(1, 5)):
    m = int(rng.choice([1, 7, 300, 4000]))
    comps = np.arange(n_total, n_total + m)
    uni.append(comps)
    uoff.append(uoff[-1] + m)
    # pins: random subsets of the label's components, each component in
    # at least its own pin
    for c in comps:
      extra = rng.choice(comps, size=rng.randint(0, 6))
      cids.append(np.unique(np.concatenate([[c], extra])))
      coff.append(coff[-1] + len(cids[-1]))
      choice.append(len(coff) - 2)
    n_total += m
  args = (np.concatenate(uni).astype(np.uint32), np.asarray(uoff, np.int64),
          np.asarray(choice, np.int32), np.asarray(coff, np.int64),
          np.concatenate(cids).astype(np.uint32))
  got = pins.pick(*args)
  monkeypatch.setattr(native, "pins_pick", lambda *a: None)
  want = pins.pick(*args)
  assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("vol", [
  smooth_volume((20, 18, 1), 4, 9, 12),  # one slice: flat even with pins
  smooth_volume((33, 17, 9), 5, 31, 40, np.uint16),
  np.asfortranarray(np.random.RandomState(3).randint(
    0, 9, (15, 11, 3)).astype(np.uint8)),  # few pairs: permissible, flat
  np.zeros((3, 5, 7), np.uint64),  # labels of 0 alone, stored in 1 byte
  np.zeros((0, 4, 3), np.uint32),  # empty
], ids=["one_slice", "pins", "few_pairs", "zeros", "empty"])
@pytest.mark.parametrize("allow_pins", [0, 1])
def test_stream_header_is_the_references_choice(vol, allow_pins):
  """codec.stream_header, the format decision of the host and device
  encoders, writes the reference's header."""
  want = crackle.compress(vol, allow_pins=allow_pins)
  flat = vol.ravel(order="F")
  head = codec.stream_header(
    vol.shape, vol.dtype.itemsize, int(flat.max()) if flat.size else 0,
    int(np.count_nonzero(flat[1:] == flat[:-1])), vol.flags.f_contiguous,
    allow_pins)
  head.num_label_bytes = codec.header(want).num_label_bytes
  assert head.tobytes() == want[:head.header_bytes]


@pytest.mark.parametrize("cause", ["declined", "trace overflowed"])
def test_pins_compress_on_a_device_raises_where_encode_fails(monkeypatch,
                                                             cause):
  """Labels on a device other than the CPU never reach the host pins
  encoder: where the device encode declines or its trace overflows,
  compress raises with the reason."""
  t = torch.zeros((4, 4, 2), dtype=torch.uint32, device="meta")
  if cause == "declined":
    monkeypatch.setattr(tenc.native, "available", lambda: False)
    match = "native trace library is missing"
  else:  # the meta tensor holds no values to encode: stand in for it
    monkeypatch.setattr(tenc, "encode_pins_device", lambda *a, **k: None)
    match = "the native trace overflowed"
  with pytest.raises(RuntimeError, match=match):
    codec.compress(t, allow_pins=1)


def test_pins_compress_of_a_cpu_tensor_whose_trace_overflows(monkeypatch):
  """On the CPU a failed device pins encode takes the host path, with
  the reference's bytes."""
  vol = smooth_volume((40, 36, 16), 4, 3, 50)
  monkeypatch.setattr(tenc, "_trace", lambda *a, **k: None)
  assert codec.compress(as_tensor(vol), allow_pins=1) == \
    crackle.compress(vol, allow_pins=1)
