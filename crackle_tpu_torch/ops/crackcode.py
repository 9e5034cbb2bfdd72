"""Crack-code boundary codec.

Reference parity: src/crackcodes.hpp. The crack code is a Freeman-style
chain code on the dual (corner) grid of a 2D slice. Moves are 2-bit
codes (UP=00, RIGHT=01, DOWN=10, LEFT=11), diff-coded mod 4, packed 4
per byte LSB-first, prefixed by a "beginning of chain" (BOC) index.
Branch ('b') and terminate ('t') are encoded as impossible reversal
pairs: b = (UP,DOWN) or (LEFT,RIGHT); t = (DOWN,UP) or (RIGHT,LEFT),
disambiguated by the previous emitted codepoint.

The encoder's traversal (edge choice by ctz order, branch fixups) is
format-visible, so it is replicated exactly (create_crack_codes,
remove_initial_branch, remove_spurious_branches).

The decoder here is a NEW data-parallel formulation (unlike the
reference's sequential state machines) so the same math runs
vectorized on host numpy and on the device:

  1. symbol classification: a codepoint is the second half of a b/t
     pair iff it reverses its predecessor AND the predecessor is not
     itself a pair-second -- a linear boolean recurrence
     s[i] = r[i] & ~s[i-1] that resolves to run-parity of the
     "reversal" indicator, computable with vector ops.
  2. chain segmentation: with tok = +1 for 'b', -1 for 't', chains end
     exactly at strict new minima of cumsum(tok).
  3. branch-stack replay: the position after symbol i equals
     start + sum of moves k <= i whose innermost enclosing branch scope
     is still open at i. Scopes are matched parentheses; each move's
     scope close E[k] is found by sorting scope events by
     (depth, position), and the replay becomes scatter(+delta at k,
     -delta at E[k]) followed by one cumsum.
  4. VCG painting: moves scatter into two dense presence rasters
     (vertical/horizontal crack segments) from which the 4-bit voxel
     connectivity graph is assembled with pure elementwise ops.
"""
from typing import Dict, List, Tuple

import numpy as np

from ..lib import compute_byte_width, itoc, ctoi

# DirectionCode (crackcodes.hpp:20-26)
UP, RIGHT, DOWN, LEFT = 0b00, 0b01, 0b10, 0b11

# symbol kind codes used in the vectorized decoder
SYM_MOVE, SYM_BRANCH, SYM_TERM = 0, 1, 2


# ---------------------------------------------------------------------------
# ENCODE
# ---------------------------------------------------------------------------

def build_adjacency(labels_flat: np.ndarray, sx: int, sy: int,
                    permissible: bool) -> np.ndarray:
  """Corner-graph adjacency bits for a slice (Graph::init parity).

  Corner node flat index = x + (sx+1) * y. Bits: 0=right, 1=left,
  2=down, 3=up (corner-edge directions). Vertical corner edges exist
  where horizontally adjacent voxels compare EQUAL (permissible) or
  UNEQUAL (impermissible); horizontal corner edges likewise for
  vertically adjacent voxels.
  """
  sxe, sye = sx + 1, sy + 1
  a = labels_flat.reshape(sy, sx)  # row = y, col = x
  adj = np.zeros((sye, sxe), dtype=np.uint8)

  heq = (a[:, 1:] == a[:, :-1])  # voxel (x,y) vs (x-1,y), x in [1, sx)
  veq = (a[1:, :] == a[:-1, :])  # voxel (x,y) vs (x,y-1), y in [1, sy)
  if not permissible:
    heq = ~heq
    veq = ~veq

  # vertical corner edge at corner-column x (1..sx-1), joining corners
  # (x, y) and (x, y+1) -- from horizontally adjacent voxel comparison
  vput = np.zeros((sye, sxe), dtype=bool)
  vput[:sy, 1:sx] = heq
  adj[vput] |= 0b0100          # node_up gains "down"
  vput2 = np.zeros((sye, sxe), dtype=bool)
  vput2[1:sy + 1, 1:sx] = heq
  adj[vput2] |= 0b1000         # node_down gains "up"

  # horizontal corner edge at corner-row y (1..sy-1), joining corners
  # (x, y) and (x+1, y) -- from vertically adjacent voxel comparison
  hput = np.zeros((sye, sxe), dtype=bool)
  hput[1:sy, :sx] = veq
  adj[hput] |= 0b0001          # node_left gains "right"
  hput2 = np.zeros((sye, sxe), dtype=bool)
  hput2[1:sy, 1:sx + 1] = veq
  adj[hput2] |= 0b0010         # node_right gains "left"

  return adj.ravel()


_POPCOUNT4 = np.array([0, 1, 1, 2, 1, 2, 2, 3, 1, 2, 2, 3, 2, 3, 3, 4],
                      dtype=np.uint8)
_CTZ4 = np.array([4, 0, 1, 0, 2, 0, 1, 0, 3, 0, 1, 0, 2, 0, 1, 0],
                 dtype=np.int8)

# erase masks per direction index (0=right,1=left,2=down,3=up):
# (mask on `node`, mask on `next_node`)
_SYMS = b'rldu'


def trace_crack_codes(adjacency: np.ndarray, sx: int, sy: int
                      ) -> List[Tuple[int, bytearray]]:
  """DFS-trace all chains (create_crack_codes parity).

  Edge selection is by ctz of the adjacency bits; branches push the
  node on a revisit stack. Returns list of (start_node, symbol string)
  pairs in discovery order (symbols from 'udlrbts').

  Host-side sequential kernel; slices provide the parallel axis.
  """
  sxe = sx + 1
  adj = adjacency  # mutated in place
  deltas = (1, -1, sxe, -sxe)
  chains: List[Tuple[int, bytearray]] = []

  candidates = np.flatnonzero(adj)
  popc = _POPCOUNT4
  ctz = _CTZ4

  for start_node in candidates:
    start_node = int(start_node)
    if not adj[start_node]:
      continue

    node = start_node
    code = bytearray()
    branches_taken = 1
    revisit: List[int] = []

    while adj[node] or revisit:
      a = int(adj[node])
      if not a:
        code.append(116)  # 't'
        branches_taken -= 1
        node = revisit.pop()
        continue
      if popc[a] > 1:
        code.append(98)  # 'b'
        revisit.append(node)
        branches_taken += 1

      d = int(ctz[a])
      nxt = node + deltas[d]
      code.append(_SYMS[d])
      # erase the edge from both endpoints
      if d == 0:    # right
        adj[node] &= 0b1110
        adj[nxt] &= 0b1101
      elif d == 1:  # left
        adj[nxt] &= 0b1110
        adj[node] &= 0b1101
      elif d == 2:  # down
        adj[node] &= 0b1011
        adj[nxt] &= 0b0111
      else:         # up
        adj[nxt] &= 0b1011
        adj[node] &= 0b0111
      node = nxt

    code.extend(b't' * branches_taken)

    start_node = remove_initial_branch(start_node, code, sx, sy)
    remove_spurious_branches(code)
    chains.append((start_node, code))

  return chains


_FLIP = {117: 100, 100: 117, 108: 114, 114: 108, 115: 115}  # u<->d l<->r s
_MVMT = {117: (0, -1), 100: (0, 1), 108: (-1, 0), 114: (1, 0), 115: (0, 0)}


def remove_initial_branch(node: int, code: bytearray, sx: int, sy: int) -> int:
  """If the chain opens with a simple branch, reverse its first segment
  and relocate the start node to that segment's end
  (remove_initial_branch parity, crackcodes.hpp:185-242)."""
  if not code or code[0] != ord('b'):
    return node
  i = 1
  while code[i] != ord('t'):
    if code[i] == ord('b'):
      return node
    i += 1

  sxe = sx + 1
  y, x = divmod(node, sxe)

  code[0] = ord('s')
  i = 1
  while code[i] != ord('t'):
    dx, dy = _MVMT[code[i]]
    x += dx
    y += dy
    code[i] = _FLIP[code[i]]
    i += 1
  code[i] = ord('s')
  last = i - 1
  code[1:last + 1] = code[1:last + 1][::-1]
  return x + sxe * y


def remove_spurious_branches(code: bytearray) -> None:
  """Erase b/t pairs that guard zero moves (parity with
  remove_spurious_branches, crackcodes.hpp:250-281)."""
  branch_stack = [-1]
  n = len(code)
  branch_lens = np.zeros(n + 1, dtype=np.uint32)
  to_erase = []
  current_branch = -1
  B, T = ord('b'), ord('t')
  for i in range(n):
    c = code[i]
    if c == B:
      branch_stack.append(i)
    elif c == T:
      if current_branch >= 0 and branch_lens[current_branch + 1] == 0:
        to_erase.append((current_branch, i))
      if branch_stack:
        current_branch = branch_stack[-1]
        branch_stack.pop()
    else:
      branch_lens[current_branch + 1] += 1
  for a, b in to_erase:
    code[a] = ord('s')
    code[b] = ord('s')


def symbols_to_codepoints(chains) -> Dict[int, List[int]]:
  """Map symbol chains to 2-bit codepoint chains; 'b'/'t' become
  reversal pairs chosen by the previous codepoint
  (symbols_to_codepoints parity, crackcodes.hpp:128-183)."""
  out: Dict[int, List[int]] = {}
  for node, chain in chains:
    code: List[int] = []
    for i in range(len(chain)):
      symbol = chain[i]
      if symbol == ord('s'):
        continue
      elif symbol == ord('b'):
        if i > 0 and code and code[-1] != DOWN:
          code.append(UP)
          code.append(DOWN)
        else:
          code.append(LEFT)
          code.append(RIGHT)
      elif symbol == ord('t'):
        if i > 0 and code and code[-1] != UP:
          code.append(DOWN)
          code.append(UP)
        else:
          code.append(RIGHT)
          code.append(LEFT)
      elif symbol == ord('u'):
        code.append(UP)
      elif symbol == ord('d'):
        code.append(DOWN)
      elif symbol == ord('l'):
        code.append(LEFT)
      else:  # 'r'
        code.append(RIGHT)
    out[int(node)] = code
  return out


def create_crack_codes(labels_flat: np.ndarray, sx: int, sy: int,
                       permissible: bool) -> Dict[int, List[int]]:
  """Full encode of one slice: labels -> {start_node: codepoints}."""
  from .. import native
  res = native.trace_slice(labels_flat, sx, sy, permissible)
  if res is not None:
    nodes, cp_lens, cps = res
    out: Dict[int, List[int]] = {}
    off = 0
    for node, ln in zip(nodes.tolist(), cp_lens.tolist()):
      out[int(node)] = cps[off:off + ln]
      off += ln
    return out
  adj = build_adjacency(labels_flat, sx, sy, permissible)
  if not adj.any():
    return {}
  chains = trace_crack_codes(adj, sx, sy)
  return symbols_to_codepoints(chains)


# ---------------------------------------------------------------------------
# BOC (beginning-of-chain) index
# ---------------------------------------------------------------------------

def write_boc_index(sorted_nodes, sx: int, sy: int) -> bytes:
  """Delta-coded chain start index (write_boc_index parity)."""
  sxe = sx + 1
  x_width = compute_byte_width(sx + 1)
  y_width = compute_byte_width(sy + 1)

  boc: Dict[int, List[int]] = {}
  for node in sorted_nodes:
    y, x = divmod(int(node), sxe)
    boc.setdefault(y, []).append(x)
  all_y = sorted(boc.keys())

  index_size = y_width
  for y in all_y:
    index_size += y_width + (len(boc[y]) + 1) * x_width

  parts = [itoc(index_size, 4), itoc(len(all_y), y_width)]
  prev_y = 0
  for i, y in enumerate(all_y):
    parts.append(itoc(y if i == 0 else y - prev_y, y_width))
    prev_y = y
    xs = boc[y]
    parts.append(itoc(len(xs), x_width))
    last_x = 0
    for x in xs:
      parts.append(itoc(x - last_x, x_width))
      last_x = x
  return b''.join(parts)


def read_boc_index(code: bytes, sx: int, sy: int) -> np.ndarray:
  """Parse the BOC index; returns chain start nodes in stored order."""
  sxe = sx + 1
  x_width = compute_byte_width(sx + 1)
  y_width = compute_byte_width(sy + 1)

  nodes = []
  idx = 4  # skip index size
  num_y = ctoi(code, idx, y_width)
  idx += y_width
  y = 0
  for _ in range(num_y):
    y += ctoi(code, idx, y_width)
    idx += y_width
    num_x = ctoi(code, idx, x_width)
    idx += x_width
    x = 0
    for _ in range(num_x):
      x += ctoi(code, idx, x_width)
      idx += x_width
      nodes.append(x + sxe * y)
  return np.asarray(nodes, dtype=np.int64)


# ---------------------------------------------------------------------------
# Codepoint packing (non-markov)
# ---------------------------------------------------------------------------

def concat_chain_codepoints(chains: Dict[int, List[int]]
                            ) -> Tuple[np.ndarray, np.ndarray]:
  """Concatenate chains in sorted-node order.

  Returns (sorted nodes, raw codepoints)."""
  nodes = np.sort(np.asarray(list(chains.keys()), dtype=np.int64))
  if len(nodes) == 0:
    return nodes, np.zeros(0, dtype=np.uint8)
  cps = np.concatenate([
    np.asarray(chains[int(node)], dtype=np.uint8) for node in nodes
  ])
  return nodes, cps


def difference_code(cps: np.ndarray) -> np.ndarray:
  """Diff-code mod 4 with implicit leading 0 (pack_codepoints parity;
  markov::difference_codepoints keeps the first element raw, which is
  the same formula)."""
  if len(cps) == 0:
    return cps
  prev = np.concatenate([[0], cps[:-1]]).astype(np.int16)
  return ((cps.astype(np.int16) - prev) & 0b11).astype(np.uint8)


def undifference_code(diffs: np.ndarray) -> np.ndarray:
  """Inverse of difference_code: cumulative sum mod 4."""
  if len(diffs) == 0:
    return diffs.astype(np.uint8)
  return (np.cumsum(diffs.astype(np.int64)) & 0b11).astype(np.uint8)


def pack_codepoints(chains: Dict[int, List[int]], sx: int, sy: int) -> bytes:
  """BOC index ++ diff-coded codepoints packed 4 per byte LSB-first."""
  nodes, cps = concat_chain_codepoints(chains)
  binary = write_boc_index(nodes, sx, sy)
  diffs = difference_code(cps)
  n = len(diffs)
  if n == 0:
    return binary
  pad = (-n) % 4
  if pad:
    diffs = np.concatenate([diffs, np.zeros(pad, dtype=np.uint8)])
  quads = diffs.reshape(-1, 4).astype(np.uint8)
  packed = (quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4)
            | (quads[:, 3] << 6))
  return binary + packed.tobytes()


def unpack_codepoints(code: bytes, offset: int) -> np.ndarray:
  """Packed bytes -> diff-decoded codepoint stream (unpack_codepoints
  parity). The trailing partial byte decodes as garbage codepoints that
  downstream chain segmentation ignores, like the reference."""
  b = np.frombuffer(code, dtype=np.uint8, offset=offset)
  if len(b) == 0:
    return np.zeros(0, dtype=np.uint8)
  diffs = np.empty((len(b), 4), dtype=np.uint8)
  diffs[:, 0] = b & 3
  diffs[:, 1] = (b >> 2) & 3
  diffs[:, 2] = (b >> 4) & 3
  diffs[:, 3] = (b >> 6) & 3
  return undifference_code(diffs.ravel())


# ---------------------------------------------------------------------------
# DECODE: vectorized symbol classification, chain segmentation, replay
# ---------------------------------------------------------------------------

def classify_codepoints(cps: np.ndarray):
  """Classify each codepoint of the stream.

  Returns (is_pair_second, kind) where kind[i] applies to the SYMBOL
  anchored at codepoint i:
    SYM_MOVE for plain moves,
    SYM_BRANCH / SYM_TERM at the FIRST codepoint of a b/t pair.
  Positions flagged is_pair_second carry no symbol.

  Replicates the reference state machine (crackcodes.hpp:523-603): a
  codepoint is a pair-second iff it reverses its predecessor and the
  predecessor is not itself a pair-second; the recurrence
  s[i] = r[i] & ~s[i-1] resolves to "odd positions within runs of the
  reversal indicator are not pair-seconds".
  """
  n = len(cps)
  if n == 0:
    return np.zeros(0, dtype=bool), np.zeros(0, dtype=np.int8)
  r = np.zeros(n, dtype=bool)
  r[1:] = (cps[1:] ^ cps[:-1]) == 0b10
  # run-parity: s[i] = r[i] and (i - run_start) is even
  idx = np.arange(n)
  run_start = np.where(r & ~np.concatenate([[False], r[:-1]]), idx, 0)
  run_start = np.maximum.accumulate(np.where(r, run_start, -1))
  s = r & (((idx - run_start) & 1) == 0)

  kind = np.zeros(n, dtype=np.int8)
  pair_first = np.zeros(n, dtype=bool)
  pair_first[:-1] = s[1:]
  # second element UP(00) or LEFT(11) => terminate; DOWN/RIGHT => branch
  second = np.zeros(n, dtype=np.uint8)
  second[:-1] = cps[1:]
  is_term = (second == UP) | (second == LEFT)
  kind[pair_first & is_term] = SYM_TERM
  kind[pair_first & ~is_term] = SYM_BRANCH
  return s, kind


def segment_chains(kind: np.ndarray, is_second: np.ndarray, num_chains: int):
  """Find the chain-end codepoint index for each chain.

  Each chain starts with an implicit branch count of 1; 'b' adds one,
  't' subtracts one; the chain ends when the count returns to zero.
  Over the concatenated stream this means: chain k ends at the k-th
  strict new minimum of cumsum(b - t). Returns (ends, valid) where
  ends[k] is the index of the last codepoint of chain k.
  """
  tok = np.zeros(len(kind), dtype=np.int64)
  tok[kind == SYM_BRANCH] = 1
  tok[kind == SYM_TERM] = -1
  c = np.cumsum(tok)
  runmin = np.minimum.accumulate(np.concatenate([[0], c]))[:-1]
  is_end = (c < runmin)
  ends = np.flatnonzero(is_end)
  # the end lands on the pair-FIRST index; the pair second is end+1
  if len(ends) < num_chains:
    return ends, False
  return ends[:num_chains], True


_DELTA_FLAT = None


def replay_positions(cps: np.ndarray, kind: np.ndarray,
                     is_second: np.ndarray, nodes: np.ndarray,
                     ends: np.ndarray, sxe: int):
  """Compute the corner position BEFORE each move codepoint, flat
  (x + sxe*y), replaying the branch stack without serial state.

  See module docstring: each move's contribution is cancelled at the
  close of its innermost enclosing scope; scopes are matched by
  sorting (depth, position) events.
  """
  n = len(cps)
  num_chains = len(nodes)
  if n == 0 or num_chains == 0:
    return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool)

  last = int(ends[-1]) + 2  # include final pair second
  last = min(last, n)
  cps = cps[:last]
  kind = kind[:last]
  is_second = is_second[:last]
  n = last

  idx = np.arange(n, dtype=np.int64)

  # chain id per codepoint: ends[k] is last index of chain k
  chain_of = np.searchsorted(ends, idx, side='left')
  chain_of = np.minimum(chain_of, num_chains - 1)
  chain_start = np.concatenate([[0], ends[:-1] + 2])  # after pair second

  is_move = (kind == SYM_MOVE) & ~is_second
  is_branch = kind == SYM_BRANCH
  is_term = kind == SYM_TERM

  # depth after each codepoint; tokens counted at pair-first position
  tok = np.zeros(n, dtype=np.int64)
  tok[is_branch] = 1
  tok[is_term] = -1
  c = np.cumsum(tok)
  depth_after = c + chain_of + 1  # +1: implicit open per chain

  # scope events: real opens at branches, virtual opens at chain starts;
  # closes at terms. Use doubled positions so virtual opens sort before
  # the chain's first codepoint.
  # depth_after is chain-local (the completed-chain count in c cancels
  # against chain_of), so every chain's virtual open sits at depth 1;
  # same-depth scopes from different chains are disjoint in position,
  # which keeps the positional pairing valid.
  open_pos = np.concatenate([2 * idx[is_branch], 2 * chain_start - 1])
  open_depth = np.concatenate([
    depth_after[is_branch],
    np.ones(num_chains, dtype=np.int64),
  ])

  close_pos = 2 * idx[is_term]
  close_depth = depth_after[is_term] + 1

  BIG = 2 * n + 2
  okeys = open_depth * BIG + open_pos
  ckeys = close_depth * BIG + close_pos

  oorder = np.argsort(okeys, kind='stable')
  corder = np.argsort(ckeys, kind='stable')
  if len(oorder) != len(corder):
    raise ValueError("crackle: corrupt crack code (unbalanced branches)")
  # after sorting by (depth, position), the i-th open matches the i-th
  # close at the same depth; intervals at equal depth are disjoint and
  # ordered, so the pairing is positional
  open_pos_sorted = open_pos[oorder]
  okeys_sorted = okeys[oorder]
  close_for_open = close_pos[corder] // 2  # codepoint index of the close

  # enclosing scope of each move: the last open at the move's depth at
  # or before it
  move_idx = idx[is_move]
  move_depth = depth_after[is_move]
  mkeys = move_depth * BIG + 2 * move_idx
  oi = np.searchsorted(okeys_sorted, mkeys, side='right') - 1
  if len(move_idx) and (oi < 0).any():
    raise ValueError("crackle: corrupt crack code (orphan move)")
  close_of_move = close_for_open[oi] if len(move_idx) else move_idx

  # displacement per move (corner flat coords)
  delta_lut = np.array([-sxe, 1, sxe, -1], dtype=np.int64)  # u r d l
  deltas = delta_lut[cps[move_idx]] if len(move_idx) else \
      np.zeros(0, dtype=np.int64)

  # scatter +delta at move, -delta at scope close; +start at chain
  # start, -start at next chain start; cumsum -> position AFTER each
  # codepoint
  acc = np.zeros(n + 1, dtype=np.int64)
  np.add.at(acc, move_idx, deltas)
  np.add.at(acc, close_of_move, -deltas)
  np.add.at(acc, chain_start, nodes)
  np.add.at(acc, np.concatenate([chain_start[1:], [n]]), -nodes)
  pos_after = np.cumsum(acc[:n])

  pos_before_moves = pos_after[move_idx] - deltas
  return pos_before_moves, is_move


def paint_vcg(pos_before: np.ndarray, dirs: np.ndarray, sx: int, sy: int,
              permissible: bool) -> np.ndarray:
  """Moves (corner position before move, direction) -> 4-bit voxel
  connectivity graph, flat x-fastest uint8.

  Bits: 0=+x, 1=-x, 2=+y, 3=-y passable (decode_*_crack_code parity).
  """
  sxe = sx + 1
  sye = sy + 1

  y = pos_before // sxe
  x = pos_before - y * sxe

  if len(pos_before):
    bad = (pos_before < 0) | (pos_before >= sxe * sye)
    if bad.any():
      raise ValueError("crackle: decode_crack_code: index out of range.")

  # vertical segments: presence[corner-x, voxel-row], shape (sy, sxe)
  # horizontal segments: presence[voxel-col, corner-row], shape (sye, sx)
  is_u = dirs == UP
  is_d = dirs == DOWN
  is_l = dirs == LEFT
  is_r = dirs == RIGHT

  v_idx = np.concatenate([
    x[is_u] + sxe * (y[is_u] - 1),
    x[is_d] + sxe * y[is_d],
  ])
  h_idx = np.concatenate([
    (x[is_l] - 1) + sx * y[is_l],
    x[is_r] + sx * y[is_r],
  ])

  V = np.zeros(sy * sxe, dtype=np.int64)
  H = np.zeros(sye * sx, dtype=np.int64)
  if len(v_idx):
    V = np.bincount(v_idx, minlength=sy * sxe)
  if len(h_idx):
    H = np.bincount(h_idx, minlength=sye * sx)
  V2 = (V > 0).reshape(sy, sxe)
  H2 = (H > 0).reshape(sye, sx)

  vcg = (V2[:, 1:].astype(np.uint8)            # bit0: +x
         | (V2[:, :sx].astype(np.uint8) << 1)  # bit1: -x
         | (H2[1:, :].astype(np.uint8) << 2)   # bit2: +y
         | (H2[:sy, :].astype(np.uint8) << 3)) # bit3: -y
  vcg = vcg.ravel()
  if not permissible:
    vcg = (0b1111 ^ vcg).astype(np.uint8)
  return vcg


def codepoints_to_vcg(cps: np.ndarray, nodes: np.ndarray, sx: int, sy: int,
                      permissible: bool) -> np.ndarray:
  """Decoded codepoint stream + BOC nodes -> VCG for one slice."""
  if len(nodes) == 0:
    base = 0 if permissible else 0b1111
    return np.full(sx * sy, base, dtype=np.uint8)
  is_second, kind = classify_codepoints(cps)
  ends, ok = segment_chains(kind, is_second, len(nodes))
  if not ok:
    raise ValueError("crackle: corrupt crack code (chain underrun)")
  pos_before, is_move = replay_positions(
    cps, kind, is_second, nodes, ends, sx + 1
  )
  move_dirs = cps[:len(is_move)][is_move]
  return paint_vcg(pos_before, move_dirs, sx, sy, permissible)


def slice_code_to_vcg(code: bytes, sx: int, sy: int,
                      permissible: bool) -> np.ndarray:
  """Full non-markov decode of one slice's crack code bytes to VCG."""
  if len(code) == 0:
    base = 0 if permissible else 0b1111
    return np.full(sx * sy, base, dtype=np.uint8)
  index_size = 4 + ctoi(code, 0, 4)
  nodes = read_boc_index(code, sx, sy)
  cps = unpack_codepoints(code, index_size)
  return codepoints_to_vcg(cps, nodes, sx, sy, permissible)


# ---------------------------------------------------------------------------
# Decode back to symbols (for reencode / debugging)
# ---------------------------------------------------------------------------

def codepoints_to_symbol_chains(cps: np.ndarray, nodes: np.ndarray):
  """Reconstruct (node, symbol bytes) chains from a codepoint stream
  (packed_codepoints_to_symbols parity). Used by markov reencoding."""
  if len(nodes) == 0:
    return []
  is_second, kind = classify_codepoints(cps)
  ends, ok = segment_chains(kind, is_second, len(nodes))
  if not ok:
    raise ValueError("crackle: corrupt crack code (chain underrun)")
  sym_lut = np.frombuffer(b'urdl', dtype=np.uint8)
  chains = []
  start = 0
  for k in range(len(nodes)):
    stop = int(ends[k]) + 2  # include pair second
    seg_kind = kind[start:stop]
    seg_sec = is_second[start:stop]
    seg_cps = cps[start:stop]
    symbols = np.where(
      seg_kind == SYM_BRANCH, ord('b'),
      np.where(seg_kind == SYM_TERM, ord('t'), sym_lut[seg_cps])
    ).astype(np.uint8)
    symbols = symbols[~seg_sec]
    chains.append((int(nodes[k]), bytes(symbols.tolist())))
    start = stop
  return chains
