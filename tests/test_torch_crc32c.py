"""The port's CRC32C of word rows equals the byte-serial reference
(lib.crc32c) and the JAX device CRC (crc32c_tpu.crc32c_device)."""
import numpy as np
import pytest
import torch

from crackle_tpu.kernels import crc32c_tpu
from crackle_tpu.lib import crc32c
from crackle_tpu_torch.kernels import crc32c as tcrc
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


def _advance(tab, r):
  """A^n(r) from byte tables tab (256, 4) of A^n."""
  return (tab[r & 0xFF, 0] ^ tab[(r >> 8) & 0xFF, 1]
          ^ tab[(r >> 16) & 0xFF, 2] ^ tab[r >> 24, 3])


def _advance_banked(image, r):
  """_advance as the kernel's lanes make it: from a table set's 8 copies
  in shared memory (image, 8192 words, slot p of copy a of entry i at
  word i*32 + 4a + p), lane l taking byte p = (k + l) mod 4 at step k.
  Each step's 32 lookups fall in 32 banks."""
  lane = np.arange(32, dtype=np.uint32)
  out = np.zeros_like(r)
  for k in range(4):
    p = (k + lane) & 3
    rot = (8 * p - 7) & 31
    x = (r >> rot) | (r << ((32 - rot) & 31))  # rotate right
    addr = ((x & 0x7F80) | (4 * (lane >> 2) + p) * 4) >> 2
    assert sorted(addr.reshape(-1, 32)[0] % 32) == list(range(32))
    out ^= image[addr]
  return out


def _shared_image(tables):
  """The chunk kernel's shared memory for a chunk_tables() array: each
  of the two byte-table sets 8 times over, [i][a][p]."""
  sets = tables[:2048].reshape(2, 256, 1, 4)
  return np.broadcast_to(sets, (2, 256, 8, 4)).reshape(2, 8192)


def _kernel_model(msgs, G, run, lanes):
  """The chunk-and-combine scheme of csrc/crc32c.cu in numpy, from the
  host functions that build its tables: chunks of G groups of lanes x
  run words aligned to the message's end, lane l's run of each group
  folded after a skip over the others', each lane advanced to its
  chunk's end and the lanes XORed; then the chunks, lane l taking
  those l + lanes j from the end."""
  B, W = msgs.shape
  cw = G * lanes * run
  nchunks = max(1, -(-W // cw))
  x = np.concatenate([np.zeros((B, nchunks * cw - W), np.uint32), msgs], 1)
  x = x.reshape(B, nchunks, G, lanes, run)
  t = tcrc.chunk_tables(run, lanes)
  fold, skip = t[:1024].reshape(256, 4), t[1024:2048].reshape(256, 4)
  cols = t[2048:].reshape(32, lanes)
  if lanes == 32:
    image = _shared_image(t)
    fold_of = lambda r: _advance_banked(image[0], r)
    skip_of = lambda r: _advance_banked(image[1], r)
  else:
    fold_of = lambda r: _advance(fold, r)
    skip_of = lambda r: _advance(skip, r)
  bit = np.arange(32, dtype=np.uint32)

  def lanes_to_end(acc, cols):
    on = ((acc[..., None, :] >> bit[:, None]) & 1).astype(bool)
    return np.bitwise_xor.reduce(
      np.bitwise_xor.reduce(np.where(on, cols, np.uint32(0)), -2), -1)

  acc = np.zeros((B, nchunks, lanes), np.uint32)
  for g in range(G):
    r = skip_of(acc)
    for j in range(run):
      r = fold_of(r ^ x[:, :, g, :, j])
    acc = r
  part = lanes_to_end(acc, cols)
  c = tcrc.combine_tables(cw, lanes)
  step, ccols = c[:1024].reshape(256, 4), c[1024:].reshape(32, lanes)
  J = -(-nchunks // lanes)
  pe = np.zeros((B, J * lanes), np.uint32)
  pe[:, :nchunks] = part[:, ::-1]  # e = l + lanes j from the end
  pe = pe.reshape(B, J, lanes)
  acc = np.zeros((B, lanes), np.uint32)
  for j in reversed(range(J)):
    acc = _advance(step, acc) ^ pe[:, j]
  return lanes_to_end(acc, ccols).astype(np.int64) ^ tcrc._c0(W)


@pytest.mark.parametrize("W", [1, 3, 129, 511, 512, 513, 4096, 5003])
@pytest.mark.parametrize("G,run,lanes", [(1, 4, 32), (2, 4, 32), (3, 4, 32),
                                         (1, 1, 4), (2, 2, 8), (5, 3, 2)])
def test_kernel_scheme_matches_reference(W, G, run, lanes):
  """The kernel's algebra on every tier: its chunk-and-combine scheme,
  at its own run and lane counts (through its banked table copies) and
  at others, equals the byte-serial CRC for ragged widths."""
  rng = np.random.RandomState(W * 7 + G)
  msgs = rng.randint(0, 2 ** 32, size=(3, W), dtype=np.uint32)
  np.testing.assert_array_equal(_kernel_model(msgs, G, run, lanes),
                                _reference(msgs))


@pytest.mark.parametrize("B,W,sms,G", [
  (512, 512 * 512, 132, 32),  # the resident decode's gate: 64 chunks a row
  (1, 512 * 512, 132, 1),
  (1024, 64, 132, 1),
  (1, 2048 * 2048, 132, 16),  # MAX_CHUNKS chunks of a long slice
  (7, 600_001, 2, 64),
  (0, 100, 132, 1)])
def test_chunk_groups_follow_the_shape(B, W, sms, G):
  assert tcrc.chunk_groups(B, W, sms) == G
  groups = -(-max(W, 1) // tcrc.GROUP)
  assert -(-groups // G) <= tcrc.MAX_CHUNKS
  want = -(-tcrc.CRC_FILL * sms // max(B, 1))
  if -(-groups // G) < tcrc.MAX_CHUNKS and G > 1:
    # CRC_FILL warps' tasks an SM, and not twice as many
    assert groups // G >= want > groups // (2 * G)


@pytest.mark.parametrize("bad", [[], [0], [2, 4], [5]])
def test_first_mismatch_names_the_least_bad_row(bad):
  rng = np.random.RandomState(5)
  msgs = rng.randint(0, 2 ** 32, size=(6, 300), dtype=np.uint32)
  stored = torch.from_numpy(_reference(msgs))
  stored[bad] ^= 1 << 31
  crc, first = tcrc.crc32c_first_mismatch(
    torch.from_numpy(msgs.view(np.int32)), stored)
  np.testing.assert_array_equal(crc.numpy(), _reference(msgs))
  assert first.dtype == torch.int32 and first.shape == (1,)
  assert int(first) == (bad[0] if bad else 6)
