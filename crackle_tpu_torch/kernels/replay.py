"""Crack-code replay: packed 2-bit moves -> 4-bit VCG, per slice.

Counterpart of crackle_tpu/kernels/replay_pallas.py (slices up to 511
wide) and replay_big.py (wider slices, longer streams): one replay
serves both shape classes. Three kernels (csrc/replay.cu):

  replay_keys       packed diffs -> event words + cls words + depth range
  replay_positions  events + cls -> masked edge ids
  paint_vcg         edge ids -> VCG (B, sy, sx) int32

The reference groups the events by depth with a sort of (depth,
position) keys (decode.py:144-187). What it computes reduces to this:
each active move at position p and depth d takes its +-1 at the first
active close q > p of depth d, and nothing if there is none. The port
computes that by a forward walk with the pending sums of each depth in
a table (replay_positions), so no sort runs on the default path.

With CANCEL_COMPACT, three kernels of csrc/compact.cu take the place of
replay_positions, giving the same edge ids element by element (the
reference's compact-cancel path, replay_big.py:878-980). cancel_sums
writes the close records in the order of the reference's sorted
(depth, position) keys without sorting: the forward walk counts each
depth's events and closes beside its pending sums. Only its plain
version sorts (sorted_keys).

  cancel_sums               events + cls -> dense close records
  compact_closes            dense records -> compact close tables
  replay_positions_compact  cls + tables -> masked edge ids

Each wrapper runs its kernel for CUDA tensors and its plain PyTorch
version for CPU tensors. The plain versions follow
decode._decode_vcg_batch, with scatter_add_/scatter_ where JAX used
one-hot matmuls, and walk the stream in tiles of TILE codepoints with
carries, so shrinking TILE exercises the carries on small streams.
"""
import functools
import os

import torch

from . import _build

# a power of two in [32, 1024]: the plain versions' tile (codepoints);
# replay_keys' block size (each thread takes 32 codepoints, so a block
# step covers 32 * TILE)
TILE = 1024

# entries of the per-depth table that each warp of replay_positions (two
# int32 an entry) and cancel_sums (four) keeps in shared memory; a slice
# whose depth range is wider is walked by one warp with the table in a
# scratch tensor in device memory. The bench volumes' slices span at most 131
# (512^3) and 328 (u64 256^2) depths. Tests shrink it to run that branch.
DEPTH_TABLE = 384

# the most warps (segments walked in parallel) a slice takes in
# replay_positions and cancel_sums; a segment holds at least 32 positions
POS_WARPS = 32

# a power of two in [32, 8192]: the positions of a slice that a block
# of replay_positions_compact takes, their cancels in shared memory (8
# bytes a position). Tests shrink it to cross window seams.
COMPACT_WINDOW = 8192

INF = torch.iinfo(torch.int64).max

UP, RIGHT, DOWN, LEFT = 0, 1, 2, 3

# the compact-cancel path in place of replay_positions; read from the
# variable that selects it in the reference (replay_big.CANCEL_COMPACT),
# so one setting picks the same path in both packages
CANCEL_COMPACT = os.environ.get("CRACKLE_TPU_CANCEL_COMPACT", "0") == "1"


def _check(name, t, dtype, ndim):
  if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
    raise ValueError(
      f"{name}: want a contiguous {ndim}-d {dtype} tensor, got "
      f"{tuple(t.shape)} {t.dtype} contiguous={t.is_contiguous()}")


def _same_device(name, *ts):
  dev = ts[0].device
  if any(t.device != dev for t in ts):
    raise ValueError(f"{name}: tensors on different devices")
  return dev.type == "cuda"


def _tile(CAP: int) -> int:
  if TILE < 32 or TILE > 1024 or TILE & (TILE - 1):
    raise ValueError(f"TILE must be a power of two in [32, 1024]: {TILE}")
  return max(32, min(TILE, CAP))


def _shift_in(x, first):
  """x shifted one step right along dim 1, `first` (B,) entering."""
  return torch.cat([first[:, None], x[:, :-1]], dim=1)


# ---------------------------------------------------------------------------
# kernel 1: event words
# ---------------------------------------------------------------------------

def unpack_diffs(packed):
  """(B, CAP_B) uint8 -> (B, 4 * CAP_B) int64 2-bit diffs."""
  b = packed.to(torch.int64)
  B = b.shape[0]
  return torch.stack([b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3],
                     dim=2).reshape(B, -1)


def event_words(depth, close, active):
  """depth << 2 | close << 1 | 1 where active, else 0 (int32)."""
  return torch.where(active, (depth << 2) | (close.to(torch.int64) << 1) | 1,
                     0).to(torch.int32)


def replay_keys_plain(packed, nbytes, n_chains):
  """Plain version of the replay_keys kernel. Returns (ev (B, CAP)
  int32 event words, cls (B, CAP) int32, drange (B, 2) int32).

  ev: depth << 2 | close << 1 | 1 at an active event (a valid move at
  its depth, or a valid terminate at the depth of the scope it closes),
  0 elsewhere. cls: cps | move << 2 | chain << 3. drange: the least and
  the largest depth of a slice's active events, (0, -1) if it has
  none."""
  B, CAP_B = packed.shape
  CAP = CAP_B * 4
  dev = packed.device
  T = _tile(CAP)
  n_cps = nbytes.to(torch.int64)[:, None] * 4
  nch = n_chains.to(torch.int64)[:, None]
  chmax = torch.clamp(nch - 1, min=0)
  idx = torch.arange(CAP, device=dev)
  diffs = torch.where(idx[None, :] < n_cps, unpack_diffs(packed), 0)
  diffs_next = torch.cat(
    [diffs[:, 1:], torch.zeros((B, 1), dtype=torch.int64, device=dev)], 1)

  def full(v):
    return torch.full((B,), v, dtype=torch.int64, device=dev)

  cps_c, prev_c, r_c, rs_c = full(0), full(255), full(0), full(-1)
  c_c, cm_c, ie_c, ec_c = full(0), full(INF), full(0), full(0)
  ev = torch.empty((B, CAP), dtype=torch.int32, device=dev)
  cls = torch.empty((B, CAP), dtype=torch.int32, device=dev)
  big = torch.iinfo(torch.int32).max
  lo, hi = full(big), full(-big)
  for t0 in range(0, CAP, T):
    sl = slice(t0, t0 + T)
    i = idx[None, sl]
    inr = i < n_cps
    cps = (torch.cumsum(diffs[:, sl], 1) + cps_c[:, None]) & 3
    prev = _shift_in(cps, prev_c)
    r = (((cps ^ prev) == 2) & inr).to(torch.int64)
    rs = torch.where((r > 0) & (_shift_in(r, r_c) == 0), i, -1)
    run_start = torch.maximum(
      torch.cummax(torch.where(r > 0, rs, -1), 1).values, rs_c[:, None])
    second = (r > 0) & (((i - run_start) & 1) == 0)

    inr1 = (i + 1) < n_cps
    cps1 = (cps + diffs_next[:, sl]) & 3
    r1 = ((cps1 ^ cps) == 2) & inr1
    pair_first = r1 & ~second
    term_pair = (cps1 == UP) | (cps1 == LEFT)
    is_term = pair_first & term_pair
    is_branch = pair_first & ~term_pair
    is_move = ~pair_first & ~second & inr

    tok = is_branch.to(torch.int64) - is_term.to(torch.int64)
    c = torch.cumsum(tok, 1) + c_c[:, None]
    cm = torch.minimum(torch.cummin(c, 1).values, cm_c[:, None])
    runmin = torch.clamp(_shift_in(cm, cm_c), max=0)
    is_end = ((c < runmin) & inr).to(torch.int64)
    end_cum = torch.cumsum(is_end, 1) + ec_c[:, None]
    cnt_before = end_cum - is_end
    chain_of = torch.minimum(torch.clamp(cnt_before, min=0), chmax)
    valid = (cnt_before < nch) | (_shift_in(is_end, ie_c) > 0)

    depth = c + chain_of + 1 + is_term
    close = (is_term & valid).to(torch.int64)
    active = valid & (is_move | is_term)
    ev[:, sl] = event_words(depth, close, active)
    lo = torch.minimum(lo, torch.where(active, depth, big).amin(1))
    hi = torch.maximum(hi, torch.where(active, depth, -big).amax(1))
    cls[:, sl] = (cps | ((is_move & valid).to(torch.int64) << 2)
                  | (chain_of << 3)).to(torch.int32)

    cps_c = prev_c = cps[:, -1]
    r_c, rs_c = r[:, -1], run_start[:, -1]
    c_c, cm_c = c[:, -1], cm[:, -1]
    ie_c, ec_c = is_end[:, -1], end_cum[:, -1]
  empty = lo > hi
  drange = torch.stack([torch.where(empty, 0, lo),
                        torch.where(empty, -1, hi)], 1)
  return ev, cls, drange.to(torch.int32)


def replay_keys(packed, nbytes, n_chains):
  """Kernel 1: packed (B, CAP_B) uint8, nbytes (B,) int32, n_chains
  (B,) int32 -> (ev (B, 4*CAP_B) int32, cls (B, 4*CAP_B) int32, drange
  (B, 2) int32); see replay_keys_plain."""
  _check("replay_keys", packed, torch.uint8, 2)
  _check("replay_keys", nbytes, torch.int32, 1)
  _check("replay_keys", n_chains, torch.int32, 1)
  B, CAP_B = packed.shape
  if nbytes.shape[0] != B or n_chains.shape[0] != B:
    raise ValueError("replay_keys: batch sizes differ")
  if not _same_device("replay_keys", packed, nbytes, n_chains):
    return replay_keys_plain(packed, nbytes, n_chains)
  CAP = CAP_B * 4
  if CAP & (CAP - 1):
    raise ValueError(f"replay_keys: CAP {CAP} is not a power of two")
  ev = torch.empty((B, CAP), dtype=torch.int32, device=packed.device)
  cls = torch.empty((B, CAP), dtype=torch.int32, device=packed.device)
  drange = torch.empty((B, 2), dtype=torch.int32, device=packed.device)
  if B:
    lib = _build.library()
    err = lib.replay_keys_launch(
      packed.data_ptr(), nbytes.data_ptr(), n_chains.data_ptr(),
      ev.data_ptr(), cls.data_ptr(), drange.data_ptr(), B, CAP_B,
      min(_tile(CAP), max(32, CAP // 32)), int(packed.data_ptr() % 8 == 0),
      torch.cuda.current_stream(packed.device).cuda_stream)
    _build.check("replay_keys", err)
    _build.LAUNCHES["replay_keys"] += 1
  return ev, cls, drange


# ---------------------------------------------------------------------------
# kernel 2: the forward walk: cancels, positions -> edge ids
# ---------------------------------------------------------------------------

def _unpack_events(ev, cls):
  """(act, close, move, depth, wh, wv) of event words: each move's H
  and V cancel contribution is -delta, LEFT +1 / RIGHT -1 in H and UP +1
  / DOWN -1 in V (in units of sx + 1)."""
  e = ev.to(torch.int64)
  act = (e & 1) > 0
  close = act & (((e >> 1) & 1) > 0)
  move = act & ~close
  cps = cls.to(torch.int64) & 3
  wh = torch.where(move & (cps == LEFT), 1, 0) - torch.where(
    move & (cps == RIGHT), 1, 0)
  wv = torch.where(move & (cps == UP), 1, 0) - torch.where(
    move & (cps == DOWN), 1, 0)
  return act, close, move, e >> 2, wh, wv


def _close_cancels(ev, cls, drange):
  """(B, 2 * CAP + 1) int64: each close's H cancel at [0, CAP) and V
  cancel at [CAP, 2 * CAP) by stream position, the sums of the moves of
  its depth since that depth's last close.

  A forward walk over tiles of TILE positions carries per depth the
  pending sums of the moves not yet flushed. Inside a tile the events
  are grouped by depth (a sort of the tile's own (depth, position)
  records), and in each group a close takes the moves since the group's
  previous close, plus the carried sums if it is the group's first."""
  B, CAP = ev.shape
  dev = ev.device
  T = _tile(CAP)
  act, close, _, depth, wh, wv = _unpack_events(ev, cls)
  lo = drange[:, :1].to(torch.int64)
  R = max(int((drange[:, 1] - drange[:, 0]).max()) + 1, 0) if B else 0
  k = torch.where(act, depth - lo, R)  # column R takes the inactive
  pend = torch.zeros((2, B, R + 1), dtype=torch.int64, device=dev)
  cancel = torch.zeros((B, 2 * CAP + 1), dtype=torch.int64, device=dev)
  for t0 in range(0, CAP, T):
    sl = slice(t0, t0 + T)
    n = k[:, sl].shape[1]
    j = torch.arange(n, device=dev)[None, :]
    order = torch.argsort(k[:, sl] * n + j, dim=1)
    ks = torch.gather(k[:, sl], 1, order)
    cl = torch.gather(close[:, sl], 1, order)
    w = torch.stack([torch.gather(wh[:, sl], 1, order),
                     torch.gather(wv[:, sl], 1, order)])
    new = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                     ks[:, 1:] != ks[:, :-1]], 1)
    last = torch.cat([ks[:, 1:] != ks[:, :-1],
                      torch.ones((B, 1), dtype=torch.bool, device=dev)], 1)
    start = torch.cummax(torch.where(new, j, -1), 1).values
    ncl = torch.cumsum(cl.to(torch.int64), 1)
    before = torch.gather(ncl - cl.to(torch.int64), 1, start)
    first_close = cl & (ncl - 1 == before)  # no close before it in its group
    any_close = ncl > before
    carried = torch.gather(pend, 2, ks.expand(2, B, n))
    cum = torch.cumsum(w, 2)
    # an anchor is a group start (the sum before it) or a close (the sum
    # at it); a close takes the sum since the last anchor before it
    anchor = torch.where(cl, cum, cum - w)
    at = torch.cummax(torch.where(new | cl, j, -1), 1).values
    at_prev = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                         at[:, :-1]], 1)
    run = torch.where(new, 0, cum - torch.gather(anchor, 2,
                                                 at_prev.expand(2, B, n)))
    val = run + torch.where(first_close, carried, 0)
    pos = order + t0
    for p, v in enumerate(val):
      cancel.scatter_(1, torch.where(cl, p * CAP + pos, 2 * CAP), v)
    # a group's last element leaves the sums after its last close, or
    # the carried sums and all of its moves if it has no close
    tail = cum - torch.gather(anchor, 2, at.expand(2, B, n))
    tail = torch.where(any_close, tail, tail + carried)
    pend.scatter_(2, torch.where(last, ks, R).expand(2, B, n), tail)
  return cancel


def sorted_keys(ev, cls):
  """The reference's sort keys rebuilt from the event words, sorted per
  slice: (depth * CAP + pos) << 3 | close << 2 | cps, INT64_MAX where
  inactive (decode.py:154-168). Only cancel_sums_plain and the tests
  read them; no kernel path sorts."""
  CAP = ev.shape[1]
  act, close, _, depth, _, _ = _unpack_events(ev, cls)
  pos = torch.arange(CAP, device=ev.device)[None, :]
  keys = torch.where(act, ((depth * CAP + pos) << 3)
                     | (close.to(torch.int64) << 2)
                     | (cls.to(torch.int64) & 3), INF)
  return torch.sort(keys, dim=1).values


def _replay_forward_plain(cancel, cls, nodes, sx: int, sy: int):
  """The forward half of both position replays: cancel (B, >= 2 * CAP)
  holds the H cancels at [0, CAP) and the V cancels at [CAP, 2 * CAP)
  by stream position. Returns edge ids (B, CAP) int32: V plane
  sy x (sx+1) first, then H plane (sy+1) x sx; -1 where there is no
  edge."""
  CAP = cls.shape[1]
  sxe = sx + 1
  NV = sy * sxe
  c = cls.to(torch.int64)
  cps = c & 3
  mv = ((c >> 2) & 1) > 0
  chain = c >> 3
  deltas = torch.where(
    cps == UP, -sxe,
    torch.where(cps == RIGHT, 1, torch.where(cps == DOWN, sxe, -1)))
  deltas = torch.where(mv, deltas, 0)
  acc = deltas + cancel[:, :CAP] + sxe * cancel[:, CAP:2 * CAP]
  pos_after = torch.cumsum(acc, 1)
  CAP_CH = nodes.shape[1]
  base = torch.gather(nodes.to(torch.int64), 1,
                      torch.clamp(chain, 0, CAP_CH - 1))
  base = torch.where(mv & (chain < CAP_CH), base, 0)
  pos_before = pos_after + base - deltas

  py = torch.div(pos_before, sxe, rounding_mode="floor")
  px = pos_before - py * sxe
  ey = torch.where(cps == UP, py - 1, py)
  ex = torch.where(cps == LEFT, px - 1, px)
  isH = (cps == RIGHT) | (cps == LEFT)
  okH = isH & (ey >= 0) & (ey <= sy) & (ex >= 0) & (ex < sx)
  okV = ~isH & (ey >= 0) & (ey < sy) & (ex >= 0) & (ex < sxe)
  ids = torch.where(isH, NV + ey * sx + ex, ey * sxe + ex)
  return torch.where(mv & (okH | okV), ids, -1).to(torch.int32)


def replay_positions_plain(ev, cls, drange, nodes, sx: int, sy: int):
  """Plain version of the replay_positions kernel: each close's cancels
  by the forward walk, then the forward replay."""
  return _replay_forward_plain(_close_cancels(ev, cls, drange), cls, nodes,
                               sx, sy)


def depth_table_stride(CAP: int) -> int:
  """Entries a slice's scratch table needs at most: active depths lie in
  [1 - terms, branches + 1] (decode.py:152-153), and a slice has at most
  CAP / 2 pairs, so its range is at most CAP / 2 + 1 wide."""
  return CAP // 2 + 2


def replay_positions(ev, cls, drange, nodes, sx: int, sy: int):
  """Kernel 2: event words (B, CAP) int32, cls (B, CAP) int32, depth
  ranges (B, 2) int32 (from replay_keys), chain start nodes (B, CAP_CH)
  int32 -> edge ids (B, CAP) int32: V plane sy x (sx+1) first, then H
  plane (sy+1) x sx; -1 where there is no edge."""
  _check("replay_positions", ev, torch.int32, 2)
  _check("replay_positions", cls, torch.int32, 2)
  _check("replay_positions", drange, torch.int32, 2)
  _check("replay_positions", nodes, torch.int32, 2)
  B, CAP = ev.shape
  if (cls.shape != ev.shape or drange.shape != (B, 2)
      or nodes.shape[0] != B):
    raise ValueError("replay_positions: shapes differ")
  if CAP & (CAP - 1):
    raise ValueError(f"replay_positions: CAP {CAP} is not a power of two")
  if (sx + 2) * (sy + 2) >= 1 << 30:
    raise ValueError("replay_positions: slice too large for int32 ids")
  if not _same_device("replay_positions", ev, cls, drange, nodes):
    return replay_positions_plain(ev, cls, drange, nodes, sx, sy)
  if DEPTH_TABLE < 1:
    raise ValueError(f"DEPTH_TABLE must be at least 1: {DEPTH_TABLE}")
  ids = torch.empty((B, CAP), dtype=torch.int32, device=ev.device)
  if B:
    # touched only by slices whose depth range passes DEPTH_TABLE
    stride = depth_table_stride(CAP)
    scratch = torch.empty((B, stride, 2), dtype=torch.int32,
                          device=ev.device)
    lib = _build.library()
    err = lib.replay_positions_launch(
      ev.data_ptr(), cls.data_ptr(), drange.data_ptr(), nodes.data_ptr(),
      scratch.data_ptr(), ids.data_ptr(), B, CAP, nodes.shape[1], sx, sy,
      DEPTH_TABLE, stride, min(POS_WARPS, max(1, CAP // 32)),
      torch.cuda.current_stream(ev.device).cuda_stream)
    _build.check("replay_positions", err)
    _build.LAUNCHES["replay_positions"] += 1
  return ids


# ---------------------------------------------------------------------------
# the compact-cancel path: per-close run sums in place of per-move cancels
# ---------------------------------------------------------------------------

def close_cap(CAP: int, CAP_CH: int) -> int:
  """Entries of a slice's compact close table: the reference's bound
  (replay_big._close_rows) on the closes of a well-formed stream,
  (CAP + 2 * CAP_CH) / 4 + 1, in rows of 128 rounded to a multiple of
  4 rows."""
  rows = -(-((CAP + 2 * CAP_CH) // 4 + 1) // 128)
  return 128 * (-(-rows // 4) * 4)


def cancel_sums_plain(ev, cls, drange):
  """Plain version of the cancel_sums kernel, on the reference's sorted
  keys (sorted_keys; drange is the kernel's and unused here). Returns
  (4, B, CAP) int32: dest (close rank, -1 elsewhere), pos (key bits &
  (CAP - 1): the event's position, CAP - 1 past the active events), sumH
  and sumV (the close's run sums, 0 elsewhere), per sorted slot."""
  skeys = sorted_keys(ev, cls)
  B, CAP = skeys.shape
  dev = skeys.device
  T = _tile(CAP)
  logcap = CAP.bit_length() - 1
  none = torch.iinfo(torch.int64).min
  inf = skeys == INF
  close = (((skeys >> 2) & 1) > 0) & ~inf
  body = skeys >> 3
  depth = body >> logcap
  cps = skeys & 3
  move = ~inf & ~close
  dh = torch.where(move & (cps == RIGHT), -1,
                   torch.where(move & (cps == LEFT), 1, 0))
  dv = torch.where(move & (cps == DOWN), -1,
                   torch.where(move & (cps == UP), 1, 0))
  first = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                     depth[:, 1:] != depth[:, :-1]], 1)

  def zeros():
    return torch.zeros(B, dtype=torch.int64, device=dev)

  cumh_c, cumv_c, lah_c, lav_c, rank_c = (zeros() for _ in range(5))
  out = torch.empty((4, B, CAP), dtype=torch.int32, device=dev)
  out[1] = (body & (CAP - 1)).to(torch.int32)
  for t0 in range(0, CAP, T):
    sl = slice(t0, t0 + T)
    fs, cl = first[:, sl], close[:, sl]
    idx = torch.arange(fs.shape[1], device=dev)[None, :]

    def last_anchor(d, cum_c, la_c):
      cum = torch.cumsum(d, 1) + cum_c[:, None]
      anchor = torch.where(fs, cum - d, torch.where(cl, cum, none))
      k = torch.cummax(torch.where(anchor != none, idx, -1), 1).values
      la = torch.where(k >= 0, torch.gather(anchor, 1, k.clamp(min=0)),
                       la_c[:, None])
      run = torch.where(cl & ~fs, cum - _shift_in(la, la_c), 0)
      return cum, la, run

    cumh, lah, runh = last_anchor(dh[:, sl], cumh_c, lah_c)
    cumv, lav, runv = last_anchor(dv[:, sl], cumv_c, lav_c)
    rank = torch.cumsum(cl.to(torch.int64), 1) + rank_c[:, None]
    out[0, :, sl] = torch.where(cl, rank - 1, -1).to(torch.int32)
    out[2, :, sl] = runh.to(torch.int32)
    out[3, :, sl] = runv.to(torch.int32)
    cumh_c, cumv_c = cumh[:, -1], cumv[:, -1]
    lah_c, lav_c, rank_c = lah[:, -1], lav[:, -1], rank[:, -1]
  return out


def cancel_sums(ev, cls, drange):
  """Kernel h: event words (B, CAP) int32, cls (B, CAP) int32, depth
  ranges (B, 2) int32 (from replay_keys) -> dense close records (4, B,
  CAP) int32 in the order of the sorted keys (dest, pos, sumH, sumV; see
  cancel_sums_plain), without a sort."""
  _check("cancel_sums", ev, torch.int32, 2)
  _check("cancel_sums", cls, torch.int32, 2)
  _check("cancel_sums", drange, torch.int32, 2)
  B, CAP = ev.shape
  if cls.shape != ev.shape or drange.shape != (B, 2):
    raise ValueError("cancel_sums: shapes differ")
  if CAP & (CAP - 1):
    raise ValueError(f"cancel_sums: CAP {CAP} is not a power of two")
  if not _same_device("cancel_sums", ev, cls, drange):
    return cancel_sums_plain(ev, cls, drange)
  if DEPTH_TABLE < 1:
    raise ValueError(f"DEPTH_TABLE must be at least 1: {DEPTH_TABLE}")
  dense = torch.empty((4, B, CAP), dtype=torch.int32, device=ev.device)
  if B:
    # touched only by slices whose depth range passes DEPTH_TABLE
    stride = depth_table_stride(CAP)
    scratch = torch.empty((B, stride, 4), dtype=torch.int32,
                          device=ev.device)
    lib = _build.library()
    err = lib.cancel_sums_launch(
      ev.data_ptr(), cls.data_ptr(), drange.data_ptr(), scratch.data_ptr(),
      dense.data_ptr(), B, CAP, DEPTH_TABLE, stride,
      min(POS_WARPS, max(1, CAP // 32)),
      torch.cuda.current_stream(ev.device).cuda_stream)
    _build.check("cancel_sums", err)
    _build.LAUNCHES["cancel_sums"] += 1
  return dense


def compact_closes_plain(dense, ccap: int):
  """Plain version of the compact_closes kernel: one scatter of the
  stacked (pos, sumH, sumV) records by rank. Returns (3, B, ccap) int32
  tables in rank order; empty entries have pos CAP and sums 0, and
  ranks at or past ccap are dropped."""
  _, B, CAP = dense.shape
  dest = dense[0].to(torch.int64)
  tgt = torch.where((dest >= 0) & (dest < ccap), dest, ccap)
  out = torch.zeros((3, B, ccap + 1), dtype=torch.int32, device=dense.device)
  out[0] = CAP
  out.scatter_(2, tgt.expand(3, B, CAP), dense[1:])
  return out[:, :, :ccap].contiguous()


def compact_closes(dense, ccap: int):
  """Kernel i: dense close records (4, B, CAP) int32 -> compact tables
  (3, B, ccap) int32 (see compact_closes_plain). The ranks of each slice
  must be a prefix count over its slots, as cancel_sums writes them: the
  kernel fills the entries from the slice's close count up as empty."""
  _check("compact_closes", dense, torch.int32, 3)
  if dense.shape[0] != 4 or ccap < 1:
    raise ValueError("compact_closes: want (4, B, CAP) records and "
                     "ccap >= 1")
  if dense.device.type != "cuda":
    return compact_closes_plain(dense, ccap)
  _, B, CAP = dense.shape
  tables = torch.empty((3, B, ccap), dtype=torch.int32, device=dense.device)
  if B:
    if dense.data_ptr() % 16:  # the kernel reads dest in 16-byte loads
      dense = dense.clone()
    # per slice: tickets << 32 | closes, added by the kernel's blocks
    scratch = torch.zeros(B, dtype=torch.int64, device=dense.device)
    lib = _build.library()
    err = lib.compact_closes_launch(
      dense.data_ptr(), tables.data_ptr(), scratch.data_ptr(), B, CAP, ccap,
      torch.cuda.current_stream(dense.device).cuda_stream)
    _build.check("compact_closes", err)
    _build.LAUNCHES["compact_closes"] += 1
  return tables


def replay_positions_compact_plain(cls, tables, nodes, sx: int, sy: int):
  """Plain version of the replay_positions_compact kernel: each table
  entry's sums at its close position, then the forward replay."""
  B, CAP = cls.shape
  pos = tables[0].to(torch.int64)
  ok = (pos >= 0) & (pos < CAP)
  cancel = torch.zeros((B, 2 * CAP + 1), dtype=torch.int64,
                       device=cls.device)
  cancel.scatter_(1, torch.where(ok, pos, 2 * CAP), tables[1].to(torch.int64))
  cancel.scatter_(1, torch.where(ok, CAP + pos, 2 * CAP),
                  tables[2].to(torch.int64))
  return _replay_forward_plain(cancel, cls, nodes, sx, sy)


def replay_positions_compact(cls, tables, nodes, sx: int, sy: int):
  """Kernel j: cls (B, CAP) int32, compact tables (3, B, CCAP) int32,
  chain start nodes (B, CAP_CH) int32 -> edge ids (B, CAP) int32, equal
  to replay_positions' on the same stream. The kernel takes windows of
  COMPACT_WINDOW positions, one block each."""
  _check("replay_positions_compact", cls, torch.int32, 2)
  _check("replay_positions_compact", tables, torch.int32, 3)
  _check("replay_positions_compact", nodes, torch.int32, 2)
  B, CAP = cls.shape
  if tables.shape[:2] != (3, B) or nodes.shape[0] != B:
    raise ValueError("replay_positions_compact: shapes differ")
  if CAP & (CAP - 1):
    raise ValueError(
      f"replay_positions_compact: CAP {CAP} is not a power of two")
  if (sx + 2) * (sy + 2) >= 1 << 30:
    raise ValueError(
      "replay_positions_compact: slice too large for int32 ids")
  if not _same_device("replay_positions_compact", cls, tables, nodes):
    return replay_positions_compact_plain(cls, tables, nodes, sx, sy)
  W = COMPACT_WINDOW
  if W < 32 or W > 8192 or W & (W - 1):
    raise ValueError(
      f"COMPACT_WINDOW must be a power of two in [32, 8192]: {W}")
  if CAP < 16:  # a thread of the kernel takes 16 positions
    raise ValueError(f"replay_positions_compact: CAP {CAP} below 16")
  W = min(W, CAP)
  ids = torch.empty((B, CAP), dtype=torch.int32, device=cls.device)
  if B:
    if tables.shape[2] % 4 or tables.data_ptr() % 16:
      # the kernel reads the table rows in 16-byte loads
      CCAP = -(-tables.shape[2] // 4) * 4
      padded = torch.full((3, B, CCAP), CAP, dtype=torch.int32,
                          device=cls.device)
      padded[:, :, :tables.shape[2]] = tables
      tables = padded
    # a ticket counter, then one look-back word a window of each slice
    state = torch.zeros(1 + B * (CAP // W), dtype=torch.int64,
                        device=cls.device)
    lib = _build.library()
    err = lib.replay_positions_compact_launch(
      cls.data_ptr(), tables.data_ptr(), nodes.data_ptr(),
      state.data_ptr(), ids.data_ptr(), B, CAP, tables.shape[2],
      nodes.shape[1], sx, sy, W,
      torch.cuda.current_stream(cls.device).cuda_stream)
    _build.check("replay_positions_compact", err)
    _build.LAUNCHES["replay_positions_compact"] += 1
  return ids


# ---------------------------------------------------------------------------
# kernel 3: VCG paint
# ---------------------------------------------------------------------------

# shared memory one block of the paint kernel may take (H100: 227 KB)
PAINT_SMEM_MAX = 232448

# blocks of the paint kernel wanted on each SM: a (bands, B) grid takes
# about as many bands as PAINT_FILL x the card's SMs hold B times (fewer,
# not more, so that no SM takes one block more than the rest) ...
PAINT_FILL = 2
# ... but no more than one a PAINT_MIN_BAND pixels (a band reads all of
# its slice's ids)
PAINT_MIN_BAND = 1024


def _band_layout(P: int, sx: int):
  """(V words, H words, split) of the shared bitmap of a band of P
  pixels of a slice sx wide, each range with a pad word after it (the
  kernel reads a word past a bit's): its V ids (at most P + (P - 1) //
  sx + 2 of them), and its H ids, one range of P + sx (top and bottom
  edges together) where a row fits the band, else (split) two of P."""
  wv = -(-(P + (P - 1) // sx + 2) // 32) + 1
  if sx <= P:
    return wv, -(-(P + sx) // 32) + 1, False
  return wv, -(-P // 32) + 1, True


def _band_words(P: int, sx: int) -> int:
  """Shared-memory words of a band of P pixels (_band_layout)."""
  wv, wh, split = _band_layout(P, sx)
  return wv + (2 if split else 1) * wh


@functools.lru_cache(maxsize=256)
def _band_px(sx: int, sy: int, smem: int) -> int:
  n = sx * sy
  words = smem // 4
  if _band_words(n, sx) <= words:
    return n
  lo, hi = 1, -(-n // 32)  # in units of 32 pixels: lo fits, hi does not
  if _band_words(32, sx) > words:
    raise ValueError(f"PAINT_SMEM_MAX {smem} holds no band")
  while hi - lo > 1:
    mid = (lo + hi) // 2
    if _band_words(32 * mid, sx) <= words:
      lo = mid
    else:
      hi = mid
  return 32 * lo


def paint_band_px(sx: int, sy: int) -> int:
  """Pixels of the largest band of the paint kernel: the whole slice
  where its bitmap fits PAINT_SMEM_MAX, else a multiple of 32 whose
  band bitmap fits."""
  return _band_px(sx, sy, PAINT_SMEM_MAX)


def paint_grid(B: int, sx: int, sy: int, sms: int):
  """(bands, band pixels P) of the paint kernel's (bands, B) grid on a
  card of `sms` SMs: want = min(floor(PAINT_FILL x sms / B), ceil(n /
  PAINT_MIN_BAND)) bands, at least 1, of equal size (rounded up to 32
  pixels, so at least 32/33 of want), or more where a band would pass
  paint_band_px. P is a multiple of 32 unless the band is the slice."""
  n = sx * sy
  want = max(1, min(PAINT_FILL * sms // max(B, 1), -(-n // PAINT_MIN_BAND)))
  P = min(paint_band_px(sx, sy), 32 * -(-n // (32 * want)))
  return -(-n // P), P


def _paint_band(ids, sx: int, sy: int, p0: int, p1: int):
  """VCG bits (B, p1 - p0) of raster pixels [p0, p1) from the edge ids
  in the band's three ranges, as the kernel's band block keeps them:
  V ids [v0, v1), H ids of the top edges [NV + p0, NV + p1) and of the
  bottom edges [NV + p0 + sx, NV + p1 + sx)."""
  B = ids.shape[0]
  sxe = sx + 1
  NV = sy * sxe
  i = ids.to(torch.int64)
  i = torch.where(i >= 0, i, -(1 << 40))  # -1 lies in no range
  p = torch.arange(p0, p1, device=ids.device)
  y, x = p // sx, p % sx
  v0 = (p0 // sx) * sxe + p0 % sx
  v1 = ((p1 - 1) // sx) * sxe + (p1 - 1) % sx + 2

  def present(a, b):
    pres = torch.zeros((B, b - a + 1), dtype=torch.int32, device=ids.device)
    pres.scatter_(1, torch.where((i >= a) & (i < b), i - a, b - a), 1)
    return pres

  V = present(v0, v1)
  Ht = present(NV + p0, NV + p1)
  Hb = present(NV + p0 + sx, NV + p1 + sx)
  v = y * sxe + x - v0
  return (V[:, v + 1] | (V[:, v] << 1) | (Hb[:, p - p0] << 2)
          | (Ht[:, p - p0] << 3))


def paint_vcg_plain(ids, sx: int, sy: int, permissible: bool):
  """Plain version of the paint_vcg kernel; past one block's shared
  memory it walks the kernel's bands (paint_band_px)."""
  B = ids.shape[0]
  P = paint_band_px(sx, sy)
  if P == sx * sy:
    sxe = sx + 1
    NV = sy * sxe
    NB = NV + (sy + 1) * sx
    i = ids.to(torch.int64)
    i = torch.where((i >= 0) & (i < NB), i, NB)
    pres = torch.zeros((B, NB + 1), dtype=torch.int32, device=ids.device)
    pres.scatter_(1, i, 1)
    V = pres[:, :NV].reshape(B, sy, sxe)
    H = pres[:, NV:NB].reshape(B, sy + 1, sx)
    vcg = (V[:, :, 1:] | (V[:, :, :sx] << 1) | (H[:, 1:, :] << 2)
           | (H[:, :sy, :] << 3))
  else:
    n = sx * sy
    vcg = torch.cat([_paint_band(ids, sx, sy, p0, min(p0 + P, n))
                     for p0 in range(0, n, P)], 1).reshape(B, sy, sx)
  return vcg if permissible else vcg ^ 0b1111


def paint_vcg(ids, sx: int, sy: int, permissible: bool):
  """Kernel 3: edge ids (B, CAP) int32, in any order -> VCG (B, sy, sx)
  int32 (complemented for impermissible streams), painted by a (bands,
  B) grid (paint_grid)."""
  _check("paint_vcg", ids, torch.int32, 2)
  if ids.device.type != "cuda":
    return paint_vcg_plain(ids, sx, sy, permissible)
  if (sx + 2) * (sy + 2) >= 1 << 30:
    raise ValueError("paint_vcg: slice too large for int32 ids")
  B, CAP = ids.shape
  vcg = torch.empty((B, sy, sx), dtype=torch.int32, device=ids.device)
  if B and sx * sy:
    bands, P = paint_grid(B, sx, sy, _build.sm_count(ids.device))
    wv, wh, split = _band_layout(P, sx)
    vec_ids = CAP % 4 == 0 and ids.data_ptr() % 16 == 0
    err = _build.library().paint_vcg_launch(
      ids.data_ptr(), vcg.data_ptr(), B, CAP, sx, sy, int(permissible), P,
      bands, wv, wh, int(split), int(vec_ids),
      torch.cuda.current_stream(ids.device).cuda_stream)
    _build.check("paint_vcg", err)
    _build.LAUNCHES["paint_vcg"] += 1
  return vcg
