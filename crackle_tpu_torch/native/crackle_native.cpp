// Native host kernels for crackle_tpu_torch (the port's copy of
// crackle_tpu/native/crackle_native.cpp).
//
// The device owns the data-parallel decode path; these C++ routines cover
// the intrinsically serial host-side hot loops (the reference keeps
// them in C++ too): the crack-code DFS trace on encode, union-find CCL
// raster scans, VCG replay for the host decode fallback, and the
// markov bitstream walk. Exposed through a plain C ABI consumed with
// ctypes (no pybind11 dependency).
//
// Semantics mirror crackle_tpu/ops/crackcode.py and ops/ccl.py, which
// follow the reference (src/crackcodes.hpp, src/cc3d.hpp).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint8_t UP = 0b00, RIGHT = 0b01, DOWN = 0b10, LEFT = 0b11;

inline int popcount4(uint8_t v) { return __builtin_popcount(v & 0xF); }
inline int ctz4(uint8_t v) { return __builtin_ctz(v); }

// ---------------------------------------------------------------------
// crack trace (encode)
// ---------------------------------------------------------------------

// Trace all chains of one slice. adjacency is the (sx+1)*(sy+1) corner
// graph bit array (mutated). Emits per chain: start node and a symbol
// string from {u,d,l,r,b,t,s}. Returns number of chains, or -1 if the
// symbol buffer overflows.
int64_t trace_slice_symbols(
  uint8_t* adj, int64_t sx, int64_t sy,
  uint8_t* out_symbols, int64_t sym_cap,
  int64_t* out_nodes, int64_t* out_lens, int64_t max_chains
) {
  const int64_t sxe = sx + 1;
  const int64_t n = sxe * (sy + 1);
  const int64_t deltas[4] = {1, -1, sxe, -sxe};
  static const char syms[4] = {'r', 'l', 'd', 'u'};

  int64_t n_chains = 0;
  int64_t sym_used = 0;
  std::vector<int64_t> revisit;
  revisit.reserve(256);

  for (int64_t start = 0; start < n; start++) {
    if (!adj[start]) continue;
    if (n_chains >= max_chains) return -1;

    int64_t node = start;
    int64_t code_begin = sym_used;
    int64_t branches_taken = 1;
    revisit.clear();

    while (adj[node] || !revisit.empty()) {
      uint8_t a = adj[node];
      if (!a) {
        if (sym_used >= sym_cap) return -1;
        out_symbols[sym_used++] = 't';
        branches_taken--;
        node = revisit.back();
        revisit.pop_back();
        continue;
      }
      if (popcount4(a) > 1) {
        if (sym_used >= sym_cap) return -1;
        out_symbols[sym_used++] = 'b';
        revisit.push_back(node);
        branches_taken++;
      }
      int d = ctz4(a);
      int64_t nxt = node + deltas[d];
      if (sym_used >= sym_cap) return -1;
      out_symbols[sym_used++] = syms[d];
      switch (d) {
        case 0: adj[node] &= 0b1110; adj[nxt] &= 0b1101; break; // right
        case 1: adj[nxt] &= 0b1110; adj[node] &= 0b1101; break; // left
        case 2: adj[node] &= 0b1011; adj[nxt] &= 0b0111; break; // down
        case 3: adj[nxt] &= 0b1011; adj[node] &= 0b0111; break; // up
      }
      node = nxt;
    }

    if (sym_used + branches_taken > sym_cap) return -1;
    for (int64_t k = 0; k < branches_taken; k++) {
      out_symbols[sym_used++] = 't';
    }

    // remove_initial_branch: if the chain opens with a simple branch,
    // reverse the first segment and relocate the start node.
    uint8_t* code = out_symbols + code_begin;
    int64_t code_len = sym_used - code_begin;
    int64_t adj_start = start;
    if (code_len > 0 && code[0] == 'b') {
      int64_t i = 1;
      bool simple = true;
      while (code[i] != 't') {
        if (code[i] == 'b') { simple = false; break; }
        i++;
      }
      if (simple) {
        int64_t y = start / sxe;
        int64_t x = start - sxe * y;
        code[0] = 's';
        i = 1;
        while (code[i] != 't') {
          switch (code[i]) {
            case 'u': y--; code[i] = 'd'; break;
            case 'd': y++; code[i] = 'u'; break;
            case 'l': x--; code[i] = 'r'; break;
            case 'r': x++; code[i] = 'l'; break;
            default: break; // 's'
          }
          i++;
        }
        code[i] = 's';
        int64_t last = i - 1;
        for (int64_t a2 = 1, b2 = last; a2 < b2; a2++, b2--) {
          uint8_t tmp = code[a2]; code[a2] = code[b2]; code[b2] = tmp;
        }
        adj_start = x + sxe * y;
      }
    }

    // remove_spurious_branches: erase b/t pairs guarding zero moves
    {
      std::vector<int64_t> branch_stack;
      branch_stack.push_back(-1);
      std::vector<uint32_t> branch_lens(code_len + 1, 0);
      std::vector<std::pair<int64_t, int64_t>> to_erase;
      int64_t current_branch = -1;
      for (int64_t i2 = 0; i2 < code_len; i2++) {
        uint8_t ch = code[i2];
        if (ch == 'b') {
          branch_stack.push_back(i2);
        } else if (ch == 't') {
          if (current_branch >= 0 && branch_lens[current_branch + 1] == 0) {
            to_erase.emplace_back(current_branch, i2);
          }
          if (!branch_stack.empty()) {
            current_branch = branch_stack.back();
            branch_stack.pop_back();
          }
        } else {
          branch_lens[current_branch + 1]++;
        }
      }
      for (auto& pr : to_erase) {
        code[pr.first] = 's';
        code[pr.second] = 's';
      }
    }

    out_nodes[n_chains] = adj_start;
    out_lens[n_chains] = code_len;
    n_chains++;
  }

  return n_chains;
}

// Shared back half of the slice trace: assemble the corner adjacency
// from the vcrack/hcrack bitmaps, DFS-trace with fixups, and convert
// symbols to codepoints. vb: sy rows x (sx+1); hb: (sy+1) rows x
// (sx+1) (last column zero).
int64_t trace_from_crack_maps(
  const uint8_t* vb, const uint8_t* hb, int64_t sx, int64_t sy,
  uint8_t* scratch_adj,
  uint8_t* scratch_symbols, int64_t sym_cap,
  uint8_t* out_cps, int64_t cps_cap,
  int64_t* out_nodes, int64_t* out_cp_lens, int64_t max_chains
) {
  const int64_t sxe = sx + 1;
  for (int64_t cy = 0; cy <= sy; cy++) {
    uint8_t* arow = scratch_adj + sxe * cy;
    const uint8_t* v0 = (cy < sy) ? vb + sxe * cy : nullptr;
    const uint8_t* v1 = (cy > 0) ? vb + sxe * (cy - 1) : nullptr;
    const uint8_t* hr = hb + sxe * cy;
    arow[0] = (uint8_t)(((v0 ? v0[0] : 0) << 2)
                        | ((v1 ? v1[0] : 0) << 3) | hr[0]);
    if (v0 && v1) {
      for (int64_t cx = 1; cx < sxe; cx++) {
        arow[cx] = (uint8_t)((v0[cx] << 2) | (v1[cx] << 3)
                             | hr[cx] | (hr[cx - 1] << 1));
      }
    } else if (v0) {  // cy == 0
      for (int64_t cx = 1; cx < sxe; cx++) {
        arow[cx] = (uint8_t)((v0[cx] << 2)
                             | hr[cx] | (hr[cx - 1] << 1));
      }
    } else {  // cy == sy
      for (int64_t cx = 1; cx < sxe; cx++) {
        arow[cx] = (uint8_t)((v1[cx] << 3)
                             | hr[cx] | (hr[cx - 1] << 1));
      }
    }
  }

  // per-thread scratch: a fresh vector would zero max_chains*8
  // bytes (~0.5 MB) on every slice
  thread_local std::vector<int64_t> sym_lens;
  if ((int64_t)sym_lens.size() < max_chains) {
    sym_lens.resize(max_chains);
  }
  int64_t n_chains = trace_slice_symbols(
    scratch_adj, sx, sy, scratch_symbols, sym_cap,
    out_nodes, sym_lens.data(), max_chains
  );
  if (n_chains < 0) return n_chains;

  // symbols -> codepoints (reversal-pair encoding of b/t)
  int64_t cp_used = 0;
  int64_t sym_off = 0;
  for (int64_t c = 0; c < n_chains; c++) {
    const uint8_t* chain = scratch_symbols + sym_off;
    int64_t len = sym_lens[c];
    int64_t cp_begin = cp_used;
    for (int64_t i = 0; i < len; i++) {
      uint8_t symbol = chain[i];
      if (symbol == 's') continue;
      if (cp_used + 2 > cps_cap) return -1;
      if (symbol == 'b') {
        if (i > 0 && cp_used > cp_begin && out_cps[cp_used - 1] != DOWN) {
          out_cps[cp_used++] = UP;
          out_cps[cp_used++] = DOWN;
        } else {
          out_cps[cp_used++] = LEFT;
          out_cps[cp_used++] = RIGHT;
        }
      } else if (symbol == 't') {
        if (i > 0 && cp_used > cp_begin && out_cps[cp_used - 1] != UP) {
          out_cps[cp_used++] = DOWN;
          out_cps[cp_used++] = UP;
        } else {
          out_cps[cp_used++] = RIGHT;
          out_cps[cp_used++] = LEFT;
        }
      } else {
        uint8_t cp = (symbol == 'u') ? UP
                   : (symbol == 'd') ? DOWN
                   : (symbol == 'l') ? LEFT : RIGHT;
        out_cps[cp_used++] = cp;
      }
    }
    out_cp_lens[c] = cp_used - cp_begin;
    sym_off += len;
  }

  return n_chains;
}

}  // namespace

extern "C" {

// Full slice encode step: build the corner adjacency from labels,
// trace, apply fixups, and convert symbols to 2-bit codepoints.
// labels: width-byte little-endian label image, flat x-fastest.
// Outputs: codepoints (concatenated, chain order = node discovery
// order), per-chain nodes and codepoint lengths.
// Returns n_chains, or -1 on buffer overflow.
int64_t crackle_trace_slice(
  const void* labels, int32_t label_width,
  int64_t sx, int64_t sy, int32_t permissible,
  uint8_t* scratch_adj,           // (sx+1)*(sy+1) bytes
  uint8_t* scratch_symbols, int64_t sym_cap,
  uint8_t* out_cps, int64_t cps_cap,
  int64_t* out_nodes, int64_t* out_cp_lens, int64_t max_chains
) {
  const int64_t sxe = sx + 1;
  const int64_t n = sxe * (sy + 1);

  // Build the corner adjacency branchlessly in two passes. The old
  // per-pixel branch-and-scatter loop ran at ~70 ns/voxel and was
  // 79% of the whole fused encode (measured: a constant slice cost
  // 632 of 800 ms over the bench volume); equality bitmaps + a
  // gather pass auto-vectorize.
  //   vcrack(x, y): crack between pixels (x-1, y) and (x, y);
  //     sets corner (x, y) bit 0b0100 and corner (x, y+1) bit 0b1000
  //   hcrack(x, y): crack between pixels (x, y-1) and (x, y);
  //     sets corner (x, y) bit 0b0001 and corner (x+1, y) bit 0b0010
  thread_local std::vector<uint8_t> vbuf, hbuf;
  if ((int64_t)vbuf.size() < sy * sxe) vbuf.resize(sy * sxe);
  if ((int64_t)hbuf.size() < (sy + 1) * sxe) {
    hbuf.resize((sy + 1) * sxe);
  }
  uint8_t* vb = vbuf.data();
  uint8_t* hb = hbuf.data();
  const uint8_t nperm = permissible ? 0 : 1;

  #define BUILD(T) do { \
    const T* L = reinterpret_cast<const T*>(labels); \
    for (int64_t y = 0; y < sy; y++) { \
      const T* row = L + sx * y; \
      uint8_t* vr = vb + sxe * y; \
      vr[0] = 0; vr[sx] = 0; \
      for (int64_t x = 1; x < sx; x++) { \
        vr[x] = (uint8_t)(row[x] == row[x - 1]) ^ nperm; \
      } \
    } \
    memset(hb, 0, sxe); \
    memset(hb + sxe * sy, 0, sxe); \
    for (int64_t y = 1; y < sy; y++) { \
      const T* row = L + sx * y; \
      const T* prow = L + sx * (y - 1); \
      uint8_t* hr = hb + sxe * y; \
      hr[sx] = 0; \
      for (int64_t x = 0; x < sx; x++) { \
        hr[x] = (uint8_t)(row[x] == prow[x]) ^ nperm; \
      } \
    } \
  } while (0)

  switch (label_width) {
    case 1: BUILD(uint8_t); break;
    case 2: BUILD(uint16_t); break;
    case 4: BUILD(uint32_t); break;
    case 8: BUILD(uint64_t); break;
    default: return -2;
  }
  #undef BUILD

  return trace_from_crack_maps(
    vb, hb, sx, sy, scratch_adj, scratch_symbols, sym_cap,
    out_cps, cps_cap, out_nodes, out_cp_lens, max_chains);
}

// Like crackle_trace_slice, but from a precomputed 4-bit voxel
// connectivity graph (bits +x, -x, +y, -y PASSABLE = labels equal,
// the device boundary-extraction output, kernels/encode.py
// labels_to_vcg) instead of the label image. This is the host tail
// of the device encode: the TPU computes the VCG/CCL/label tables;
// only the intrinsically serial DFS trace runs here.
int64_t crackle_trace_slice_vcg(
  const uint8_t* vcg,             // sx*sy, flat x-fastest
  int64_t sx, int64_t sy, int32_t permissible,
  uint8_t* scratch_adj,           // (sx+1)*(sy+1) bytes
  uint8_t* scratch_symbols, int64_t sym_cap,
  uint8_t* out_cps, int64_t cps_cap,
  int64_t* out_nodes, int64_t* out_cp_lens, int64_t max_chains
) {
  const int64_t sxe = sx + 1;
  thread_local std::vector<uint8_t> vbuf, hbuf;
  if ((int64_t)vbuf.size() < sy * sxe) vbuf.resize(sy * sxe);
  if ((int64_t)hbuf.size() < (sy + 1) * sxe) {
    hbuf.resize((sy + 1) * sxe);
  }
  uint8_t* vb = vbuf.data();
  uint8_t* hb = hbuf.data();
  const uint8_t nperm = permissible ? 0 : 1;

  for (int64_t y = 0; y < sy; y++) {
    const uint8_t* row = vcg + sx * y;
    uint8_t* vr = vb + sxe * y;
    vr[0] = 0; vr[sx] = 0;
    for (int64_t x = 1; x < sx; x++) {
      vr[x] = (uint8_t)((row[x] >> 1) & 1) ^ nperm;  // -x passable
    }
  }
  memset(hb, 0, sxe);
  memset(hb + sxe * sy, 0, sxe);
  for (int64_t y = 1; y < sy; y++) {
    const uint8_t* row = vcg + sx * y;
    uint8_t* hr = hb + sxe * y;
    hr[sx] = 0;
    for (int64_t x = 0; x < sx; x++) {
      hr[x] = (uint8_t)((row[x] >> 3) & 1) ^ nperm;  // -y passable
    }
  }

  return trace_from_crack_maps(
    vb, hb, sx, sy, scratch_adj, scratch_symbols, sym_cap,
    out_cps, cps_cap, out_nodes, out_cp_lens, max_chains);
}

int64_t crackle_ccl_slice(
  const void* labels, int32_t label_width,
  int64_t sx, int64_t sy, uint32_t* out);

int64_t crackle_pack_chains(
  const int64_t* chain_nodes, const uint8_t* chain_cps,
  const int64_t* chain_cp_lens, int64_t n_chains,
  int64_t sx, int64_t sy, uint8_t* out_code, int64_t code_cap);

// Fused per-slice FLAT encode step: crack trace (adjacency + DFS +
// fixups + codepoints via crackle_trace_slice) packed to the wire
// format (4-byte BOC index size prefix ++ delta-coded BOC index ++
// diff-coded 2-bit moves, 4 per byte LSB-first — pack_codepoints /
// write_boc_index parity, src/crackcodes.hpp:318-372,455-496), plus
// union-find first-visit CCL with the per-component source label
// (labels.hpp:30-155's per-slice mapping). One call per z on the
// encode thread pool; the caller computes crc32c(out_cc) and merges
// the mappings into the global uniq/keys tables.
// Returns packed code byte length, or -1 on buffer overflow / -2 on
// unsupported width.
int64_t crackle_encode_slice(
  const void* labels, int32_t label_width,
  int64_t sx, int64_t sy, int32_t permissible,
  uint8_t* scratch_adj,
  uint8_t* scratch_symbols, int64_t sym_cap,
  uint8_t* scratch_cps, int64_t cps_cap,
  int64_t* scratch_nodes, int64_t* scratch_cp_lens, int64_t max_chains,
  uint8_t* out_code, int64_t code_cap,
  uint32_t* out_cc,        // sx*sy first-visit CCL image
  uint64_t* out_mapping,   // per-component first-visit source label
  int64_t* out_n           // component count
) {
  int64_t n_chains = crackle_trace_slice(
    labels, label_width, sx, sy, permissible,
    scratch_adj, scratch_symbols, sym_cap,
    scratch_cps, cps_cap, scratch_nodes, scratch_cp_lens, max_chains
  );
  if (n_chains < 0) return n_chains;

  int64_t code_len = crackle_pack_chains(
    scratch_nodes, scratch_cps, scratch_cp_lens, n_chains,
    sx, sy, out_code, code_cap);
  if (code_len < 0) return code_len;
  uint8_t* w = out_code + code_len;

  // first-visit CCL + per-component source label
  int64_t n = crackle_ccl_slice(labels, label_width, sx, sy, out_cc);
  if (n < 0) return -2;
  *out_n = n;
  {
    int64_t seen = 0;
    #define MAP(T) do { \
      const T* L = reinterpret_cast<const T*>(labels); \
      for (int64_t v = 0; v < sx * sy && seen < n; v++) { \
        if ((int64_t)out_cc[v] == seen) { \
          out_mapping[seen++] = (uint64_t)L[v]; \
        } \
      } \
    } while (0)
    switch (label_width) {
      case 1: MAP(uint8_t); break;
      case 2: MAP(uint16_t); break;
      case 4: MAP(uint32_t); break;
      case 8: MAP(uint64_t); break;
      default: return -2;
    }
    #undef MAP
  }
  return w - out_code;
}

// Wire-format packing of traced chains: sorted-node chain order, BOC
// index, diff-coded 2-bit packing (write_boc_index / pack_codepoints
// parity). Returns packed byte length or -1 on overflow.
int64_t crackle_pack_chains(
  const int64_t* chain_nodes, const uint8_t* chain_cps,
  const int64_t* chain_cp_lens, int64_t n_chains,
  int64_t sx, int64_t sy,
  uint8_t* out_code, int64_t code_cap
) {
  const int64_t* scratch_nodes = chain_nodes;
  const uint8_t* scratch_cps = chain_cps;
  const int64_t* scratch_cp_lens = chain_cp_lens;

  // chain order on the wire = sorted start node
  std::vector<int64_t> order(n_chains);
  for (int64_t i = 0; i < n_chains; i++) order[i] = i;
  std::vector<int64_t> cp_off(n_chains + 1, 0);
  for (int64_t i = 0; i < n_chains; i++) {
    cp_off[i + 1] = cp_off[i] + scratch_cp_lens[i];
  }
  // stable: the python pack path keys chains by start node (unique in
  // practice); if the tracer ever emitted two chains with the same
  // start, stable order keeps native and python byte streams aligned
  // instead of diverging silently
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return scratch_nodes[a] < scratch_nodes[b];
  });

  // BOC index: delta-coded y rows, each with count + delta-coded xs
  const int64_t sxe = sx + 1;
  auto bw = [](uint64_t x) {
    return x <= 0xFF ? 1 : x <= 0xFFFF ? 2 : x <= 0xFFFFFFFFull ? 4 : 8;
  };
  const int xw = bw((uint64_t)(sx + 1));
  const int yw = bw((uint64_t)(sy + 1));
  int64_t num_y = 0;
  int64_t prev_y = -1;
  for (int64_t i = 0; i < n_chains; i++) {
    int64_t y = scratch_nodes[order[i]] / sxe;
    if (y != prev_y) { num_y++; prev_y = y; }
  }
  uint64_t index_size = yw + (uint64_t)num_y * (yw + xw);
  for (int64_t i = 0; i < n_chains; i++) index_size += xw;
  int64_t total_cps = cp_off[n_chains];
  int64_t code_len = 4 + (int64_t)index_size + (total_cps + 3) / 4;
  if (code_len > code_cap) return -1;

  uint8_t* w = out_code;
  auto put = [&](uint64_t v, int width) {
    for (int i = 0; i < width; i++) { *w++ = (uint8_t)(v & 0xFF); v >>= 8; }
  };
  put(index_size, 4);
  put((uint64_t)num_y, yw);
  prev_y = 0;
  int64_t i = 0;
  bool first_row = true;
  while (i < n_chains) {
    int64_t y = scratch_nodes[order[i]] / sxe;
    int64_t j = i;
    while (j < n_chains && scratch_nodes[order[j]] / sxe == y) j++;
    put((uint64_t)(first_row ? y : y - prev_y), yw);
    first_row = false;
    prev_y = y;
    put((uint64_t)(j - i), xw);
    int64_t last_x = 0;
    for (int64_t k = i; k < j; k++) {
      int64_t x = scratch_nodes[order[k]] - sxe * y;
      put((uint64_t)(x - last_x), xw);
      last_x = x;
    }
    i = j;
  }

  // diff-code mod 4 across the concatenated chains, pack 4/byte
  uint8_t last_cp = 0;
  uint8_t enc = 0;
  int pos = 0;
  for (int64_t c = 0; c < n_chains; c++) {
    const uint8_t* cps = scratch_cps + cp_off[order[c]];
    int64_t len = scratch_cp_lens[order[c]];
    for (int64_t k = 0; k < len; k++) {
      uint8_t d = (uint8_t)((cps[k] - last_cp) & 0b11);
      last_cp = cps[k];
      enc |= (uint8_t)(d << pos);
      pos += 2;
      if (pos == 8) { *w++ = enc; enc = 0; pos = 0; }
    }
  }
  if (pos > 0) *w++ = enc;

  return w - out_code;
}

// Host tail of the device encode: packed wire code for one slice from
// a device-computed VCG (trace + fixups + BOC + diff-pack only; CCL,
// mappings, and CRCs come from the device). Returns packed byte
// length, or -1 on buffer overflow.
int64_t crackle_encode_slice_vcg(
  const uint8_t* vcg, int64_t sx, int64_t sy, int32_t permissible,
  uint8_t* scratch_adj,
  uint8_t* scratch_symbols, int64_t sym_cap,
  uint8_t* scratch_cps, int64_t cps_cap,
  int64_t* scratch_nodes, int64_t* scratch_cp_lens, int64_t max_chains,
  uint8_t* out_code, int64_t code_cap
) {
  int64_t n_chains = crackle_trace_slice_vcg(
    vcg, sx, sy, permissible,
    scratch_adj, scratch_symbols, sym_cap,
    scratch_cps, cps_cap, scratch_nodes, scratch_cp_lens, max_chains
  );
  if (n_chains < 0) return n_chains;
  return crackle_pack_chains(
    scratch_nodes, scratch_cps, scratch_cp_lens, n_chains,
    sx, sy, out_code, code_cap);
}

// Union-find 4-connected CCL of one slice with first-visit raster
// numbering (cc3d.hpp semantics). labels flat x-fastest.
// Returns N (component count).
int64_t crackle_ccl_slice(
  const void* labels, int32_t label_width,
  int64_t sx, int64_t sy,
  uint32_t* out  // sx*sy
) {
  const int64_t nvox = sx * sy;
  if (nvox == 0) return 0;
  thread_local std::vector<uint32_t> parent;
  parent.clear();
  parent.reserve(nvox / 4 + 8);

  auto find = [&](uint32_t v) {
    while (parent[v] != v) {
      parent[v] = parent[parent[v]];
      v = parent[v];
    }
    return v;
  };

  #define CCL(T) do { \
    const T* L = reinterpret_cast<const T*>(labels); \
    for (int64_t y = 0; y < sy; y++) { \
      for (int64_t x = 0; x < sx; x++) { \
        int64_t loc = x + sx * y; \
        T v = L[loc]; \
        bool left = (x > 0) && (L[loc - 1] == v); \
        bool up = (y > 0) && (L[loc - sx] == v); \
        if (left && up) { \
          uint32_t a = find(out[loc - 1]); \
          uint32_t b = find(out[loc - sx]); \
          uint32_t r = a < b ? a : b; \
          parent[a] = r; parent[b] = r; \
          out[loc] = r; \
        } else if (left) { \
          out[loc] = out[loc - 1]; \
        } else if (up) { \
          out[loc] = find(out[loc - sx]); \
        } else { \
          uint32_t fresh = (uint32_t)parent.size(); \
          parent.push_back(fresh); \
          out[loc] = fresh; \
        } \
      } \
    } \
  } while (0)

  switch (label_width) {
    case 1: CCL(uint8_t); break;
    case 2: CCL(uint16_t); break;
    case 4: CCL(uint32_t); break;
    case 8: CCL(uint64_t); break;
    default: return -2;
  }
  #undef CCL

  // resolve + first-visit renumber
  thread_local std::vector<uint32_t> renumber;
  renumber.assign(parent.size(), 0xFFFFFFFFu);
  uint32_t next_label = 0;
  for (int64_t i = 0; i < nvox; i++) {
    uint32_t root = find(out[i]);
    if (renumber[root] == 0xFFFFFFFFu) {
      renumber[root] = next_label++;
    }
    out[i] = renumber[root];
  }
  return next_label;
}

// Same numbering from a voxel connectivity graph (bits: 1=-x, 3=-y).
int64_t crackle_ccl_vcg_slice(
  const uint8_t* vcg, int64_t sx, int64_t sy, uint32_t* out
) {
  const int64_t nvox = sx * sy;
  if (nvox == 0) return 0;
  thread_local std::vector<uint32_t> parent;
  parent.clear();
  parent.reserve(nvox / 4 + 8);

  auto find = [&](uint32_t v) {
    while (parent[v] != v) {
      parent[v] = parent[parent[v]];
      v = parent[v];
    }
    return v;
  };

  for (int64_t y = 0; y < sy; y++) {
    for (int64_t x = 0; x < sx; x++) {
      int64_t loc = x + sx * y;
      bool left = (x > 0) && (vcg[loc] & 0b0010);
      bool up = (y > 0) && (vcg[loc] & 0b1000);
      if (left && up) {
        uint32_t a = find(out[loc - 1]);
        uint32_t b = find(out[loc - sx]);
        uint32_t r = a < b ? a : b;
        parent[a] = r; parent[b] = r;
        out[loc] = r;
      } else if (left) {
        out[loc] = out[loc - 1];
      } else if (up) {
        out[loc] = find(out[loc - sx]);
      } else {
        uint32_t fresh = (uint32_t)parent.size();
        parent.push_back(fresh);
        out[loc] = fresh;
      }
    }
  }

  thread_local std::vector<uint32_t> renumber;
  renumber.assign(parent.size(), 0xFFFFFFFFu);
  uint32_t next_label = 0;
  for (int64_t i = 0; i < nvox; i++) {
    uint32_t root = find(out[i]);
    if (renumber[root] == 0xFFFFFFFFu) {
      renumber[root] = next_label++;
    }
    out[i] = renumber[root];
  }
  return next_label;
}

// Sequential VCG replay for the host decode fallback: decoded
// codepoints -> paint presence into the edges array.
// edges preinitialized by caller (0 for permissible, 0xF impermissible).
// Returns 0 on success, -1 on out-of-range positions.
int64_t crackle_replay_vcg(
  const uint8_t* cps, int64_t n_cps,
  const int64_t* nodes, int64_t n_chains,
  int64_t sx, int64_t sy, int32_t permissible,
  uint8_t* edges
) {
  const int64_t sxe = sx + 1;
  const int64_t pixels = sxe * (sy + 1);

  auto paint = [&](int64_t loc, uint8_t bit) {
    if (permissible) edges[loc] |= bit;
    else edges[loc] &= (uint8_t)(0b1111 ^ bit);
  };

  // A codepoint that reverses its predecessor turns the pair into a
  // branch/terminate; the pair-first must NOT paint. So moves commit
  // lazily: hold one pending move, commit it only once the next
  // codepoint proves it is a real move.
  constexpr uint8_t NONE = 255;

  int64_t i = 0;
  std::vector<int64_t> revisit;
  for (int64_t c = 0; c < n_chains; c++) {
    int64_t node = nodes[c];
    int64_t y = node / sxe;
    int64_t x = node - sxe * y;
    int64_t branches = 1;
    uint8_t pending = NONE;
    revisit.clear();

    auto commit = [&](uint8_t mv) -> bool {
      // positions live on the dual grid [0..sx] x [0..sy]; a corrupt
      // stream can walk anywhere, so every paint carries both column
      // guards and the move itself must stay on the grid
      if (x < 0 || x > sx || y < 0 || y > sy) return false;
      switch (mv) {
        case UP:
          if (y <= 0) return false;
          if (x > 0) paint((x - 1) + sx * (y - 1), 0b0001);
          if (x < sx) paint(x + sx * (y - 1), 0b0010);
          y--;
          break;
        case DOWN:
          if (y >= sy) return false;
          if (x > 0) paint((x - 1) + sx * y, 0b0001);
          if (x < sx) paint(x + sx * y, 0b0010);
          y++;
          break;
        case LEFT:
          if (x <= 0) return false;
          if (y > 0) paint((x - 1) + sx * (y - 1), 0b0100);
          if (y < sy) paint((x - 1) + sx * y, 0b1000);
          x--;
          break;
        case RIGHT:
          if (x >= sx) return false;
          if (y > 0) paint(x + sx * (y - 1), 0b0100);
          if (y < sy) paint(x + sx * y, 0b1000);
          x++;
          break;
      }
      return true;
    };

    while (branches > 0 && i < n_cps) {
      uint8_t mv = cps[i++];
      if (pending != NONE && ((mv ^ pending) == 0b10)) {
        // pair: pending was the first half, never painted
        if (mv == UP || mv == LEFT) {  // terminate
          branches--;
          if (branches > 0 && !revisit.empty()) {
            int64_t loc = revisit.back();
            revisit.pop_back();
            // dual-grid packing (sxe wide): x can equal sx at a
            // right-border branch, so sx-wide packing would alias
            y = loc / sxe;
            x = loc - sxe * y;
          }
        } else {  // branch
          revisit.push_back(x + sxe * y);
          branches++;
        }
        pending = NONE;
      } else {
        if (pending != NONE) {
          if (!commit(pending)) return -1;
        }
        pending = mv;
      }
    }
    if (pending != NONE) {
      if (!commit(pending)) return -1;
      pending = NONE;
    }
  }
  return 0;
}

// Markov bitstream decode: rank codes -> diff codepoints -> undiffed
// codepoints. model_inv: rank->direction table, 4^order rows of 4.
// Returns the number of codepoints written.
int64_t crackle_markov_decode(
  const uint8_t* stream, int64_t n_bytes,
  const uint8_t* model_inv, int64_t order,
  uint8_t* out, int64_t out_cap
) {
  if (n_bytes == 0) return 0;
  const int64_t n_bits = n_bytes * 8;

  auto getbit = [&](int64_t p) -> int {
    return (stream[p >> 3] >> (p & 7)) & 1;
  };

  int64_t n_out = 0;
  uint8_t first = (uint8_t)((stream[0] & 0b11));
  if (n_out >= out_cap) return n_out;
  out[n_out++] = first;

  // context window: oldest digit at 4^0, newest at 4^(order-1)
  std::vector<uint8_t> window(order, 0);
  int64_t widx = 0;
  int64_t base10 = 0;
  if (order > 0) {
    window[widx] = first;
    widx = (widx + 1) % order;
    base10 = (int64_t)first << (2 * (order - 1));
  }

  int64_t p = 2;
  while (p < n_bits && n_out < out_cap) {
    int rank;
    if (!getbit(p)) { rank = 0; p += 1; }
    else if (p + 1 >= n_bits) { break; }
    else if (!getbit(p + 1)) { rank = 1; p += 2; }
    else if (p + 2 >= n_bits) { break; }
    else if (!getbit(p + 2)) { rank = 2; p += 3; }
    else { rank = 3; p += 3; }

    uint8_t d = model_inv[base10 * 4 + rank];
    out[n_out++] = d;
    if (order > 0) {
      uint8_t front = window[widx];
      base10 -= front;
      base10 >>= 2;
      base10 += (int64_t)d << (2 * (order - 1));
      window[widx] = d;
      widx = (widx + 1) % order;
    }
  }

  // un-diff mod 4
  uint8_t acc = 0;
  for (int64_t k = 0; k < n_out; k++) {
    acc = (uint8_t)((acc + out[k]) & 3);
    out[k] = acc;
  }
  return n_out;
}

// Markov bitstream encode from diff codepoints. model: dir->rank,
// 4^order rows of 4. Returns bytes written or -1 on overflow.
int64_t crackle_markov_encode(
  const uint8_t* diffs, int64_t n,
  const uint8_t* model, int64_t order,
  uint8_t* out, int64_t out_cap
) {
  if (n == 0) return 0;
  memset(out, 0, (size_t)out_cap);

  auto setbit = [&](int64_t p) {
    out[p >> 3] |= (uint8_t)(1 << (p & 7));
  };

  int64_t p = 2;
  out[0] = (uint8_t)(diffs[0] & 0b11);

  std::vector<uint8_t> window(order, 0);
  int64_t widx = 0;
  int64_t base10 = 0;
  if (order > 0) {
    window[widx] = diffs[0];
    widx = (widx + 1) % order;
    base10 = (int64_t)diffs[0] << (2 * (order - 1));
  }

  for (int64_t i = 1; i < n; i++) {
    uint8_t rank = model[base10 * 4 + diffs[i]];
    int len = (rank == 0) ? 1 : (rank == 1) ? 2 : 3;
    if ((p + len + 7) / 8 > out_cap) return -1;
    switch (rank) {
      case 0: break;
      case 1: setbit(p); break;
      case 2: setbit(p); setbit(p + 1); break;
      default: setbit(p); setbit(p + 1); setbit(p + 2); break;
    }
    p += len;
    if (order > 0) {
      uint8_t front = window[widx];
      base10 -= front;
      base10 >>= 2;
      base10 += (int64_t)diffs[i] << (2 * (order - 1));
      window[widx] = diffs[i];
      widx = (widx + 1) % order;
    }
  }
  return (p + 7) / 8;
}

}  // extern "C"

// =====================================================================
// Self-contained stream decompressor (C ABI).
//
// Plays the role of the reference's embeddable/wasm port
// (wasm/crackle_wasm.cc): a dependency-free decoder of full .ckl
// streams, and the fast host fallback path. Supports v1 flat-label
// streams with or without a markov model; pin streams return -3 (the
// python layer decodes those).
// =====================================================================

namespace {

uint32_t crc32c_table_[256];
bool crc32c_init_done_ = false;

void crc32c_init() {
  if (crc32c_init_done_) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i;
    for (int k = 0; k < 8; k++) {
      crc = (crc & 1) ? (crc >> 1) ^ 0x82F63B78u : crc >> 1;
    }
    crc32c_table_[i] = crc;
  }
  crc32c_init_done_ = true;
}

uint32_t crc32c(const uint8_t* data, size_t n) {
#if defined(__SSE4_2__)
  // hardware CRC32C (the reference's fastcrc uses the same
  // instructions on x86: third_party/fastcrc/crc32c_x86_64_sse.h)
  uint64_t crc = 0xFFFFFFFFull;
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t w;
    memcpy(&w, data + i, 8);
    crc = __builtin_ia32_crc32di(crc, w);
  }
  uint32_t c32 = (uint32_t)crc;
  for (; i < n; i++) {
    c32 = __builtin_ia32_crc32qi(c32, data[i]);
  }
  return c32 ^ 0xFFFFFFFFu;
#else
  crc32c_init();
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) {
    crc = crc32c_table_[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  }
  return crc ^ 0xFFFFFFFFu;
#endif
}

uint64_t rd(const uint8_t* p, int width) {
  uint64_t v = 0;
  for (int i = 0; i < width; i++) v |= (uint64_t)p[i] << (8 * i);
  return v;
}

int byte_width(uint64_t x) {
  if (x <= 0xFF) return 1;
  if (x <= 0xFFFF) return 2;
  if (x <= 0xFFFFFFFFull) return 4;
  return 8;
}

struct Header {
  int version;
  int data_width, stored_width;
  int crack_format, label_format;
  bool fortran_order, is_signed, is_sorted;
  int markov_order;
  uint64_t sx, sy, sz;
  uint64_t num_label_bytes;
};

// returns 0 ok, <0 error
int parse_header(const uint8_t* b, size_t n, Header& h) {
  if (n < 29) return -1;
  if (!(b[0]=='c' && b[1]=='r' && b[2]=='k' && b[3]=='l')) return -1;
  h.version = b[4];
  if (h.version != 1) return -1;
  uint16_t fmt = (uint16_t)rd(b + 5, 2);
  h.data_width = 1 << (fmt & 3);
  h.stored_width = 1 << ((fmt >> 2) & 3);
  h.crack_format = (fmt >> 4) & 1;
  h.label_format = (fmt >> 5) & 3;
  h.fortran_order = (fmt >> 7) & 1;
  h.is_signed = (fmt >> 8) & 1;
  h.markov_order = (fmt >> 9) & 0xF;
  h.is_sorted = !((fmt >> 13) & 1);
  h.sx = rd(b + 7, 4);
  h.sy = rd(b + 11, 4);
  h.sz = rd(b + 15, 4);
  h.num_label_bytes = rd(b + 20, 8);
  return 0;
}

}  // namespace

extern "C" {

// Standard CRC-32C of n bytes (lib.crc32c without google_crc32c).
uint32_t crackle_crc32c(const uint8_t* data, int64_t n) {
  return crc32c(data, (size_t)n);
}

// Decompress a full v1 flat-label stream into out (voxels *
// data_width bytes, fortran order as flagged in the header).
// Returns 0 on success; -1 malformed; -2 unsupported width;
// -3 pin streams (python path); -4 crc mismatch.
int64_t crackle_decompress_stream(
  const uint8_t* buf, int64_t n,
  int64_t z0, int64_t z1,
  void* out, int64_t out_cap
) {
  Header h;
  if (parse_header(buf, (size_t)n, h) != 0) return -1;
  if (h.label_format != 0) return -3;  // pins -> python
  const int64_t sx = (int64_t)h.sx, sy = (int64_t)h.sy,
                sz = (int64_t)h.sz;
  const int64_t sxy = sx * sy;
  if (z0 < 0) z0 = 0;
  if (z1 < 0 || z1 > sz) z1 = sz;
  if (z0 >= z1) return -1;
  const int64_t szr = z1 - z0;
  const int64_t voxels = sxy * szr;
  if (out_cap < voxels * h.data_width) return -1;
  if (voxels == 0) return 0;

  // z-index
  size_t off = 29;
  if ((int64_t)(off + 4 * (sz + 1)) > n) return -1;
  std::vector<uint64_t> z_len(sz);
  for (int64_t z = 0; z < sz; z++) z_len[z] = rd(buf + off + 4 * z, 4);
  uint32_t zcrc = (uint32_t)rd(buf + off + 4 * sz, 4);
  if (crc32c(buf + off, 4 * sz) != zcrc) return -4;
  off += 4 * (sz + 1);

  // flat labels. Every derived offset is validated against
  // num_label_bytes before use: a corrupt N (or component counts)
  // must fail with -1, not index outside the buffer.
  const uint8_t* lb = buf + off;
  if ((int64_t)(off + h.num_label_bytes) > n) return -1;
  if (h.num_label_bytes < 8) return -1;
  uint64_t num_labels = rd(lb, 8);
  if (num_labels > (h.num_label_bytes - 8) / (uint64_t)h.stored_width)
    return -1;
  const uint8_t* uniq = lb + 8;
  const uint8_t* cpg = uniq + num_labels * h.stored_width;
  int cw = byte_width((uint64_t)sxy);
  int kw = byte_width(num_labels);
  uint64_t fixed = 8 + num_labels * (uint64_t)h.stored_width
                 + (uint64_t)cw * sz;
  if (fixed > h.num_label_bytes) return -1;
  const uint8_t* keys = cpg + (uint64_t)cw * sz;
  std::vector<uint64_t> cum(sz + 1, 0);
  for (int64_t z = 0; z < sz; z++) {
    cum[z + 1] = cum[z] + rd(cpg + (uint64_t)cw * z, cw);
  }
  if (cum[sz] > (h.num_label_bytes - fixed) / (uint64_t)kw) return -1;
  off += h.num_label_bytes;

  // markov model
  std::vector<uint8_t> model_inv;  // rank -> dir, 4^k rows
  if (h.markov_order > 0) {
    uint64_t rows = 1;
    for (int i = 0; i < h.markov_order; i++) rows *= 4;
    uint64_t mbytes = (rows * 5 + 4) / 8;
    if ((int64_t)(off + mbytes) > n) return -1;
    model_inv.resize(rows * 4);
    // 24 permutations of (0,1,2,3) in lexicographic (itertools) order
    uint8_t perms[24][4];
    {
      int idx = 0;
      int a[4] = {0, 1, 2, 3};
      // generate lexicographic permutations
      int p0[4];
      for (p0[0] = 0; p0[0] < 4; p0[0]++)
      for (p0[1] = 0; p0[1] < 4; p0[1]++)
      for (p0[2] = 0; p0[2] < 4; p0[2]++)
      for (p0[3] = 0; p0[3] < 4; p0[3]++) {
        bool ok = true;
        for (int i = 0; i < 4 && ok; i++)
          for (int j = i + 1; j < 4; j++)
            if (p0[i] == p0[j]) { ok = false; break; }
        if (ok) {
          for (int i = 0; i < 4; i++) perms[idx][i] = (uint8_t)p0[i];
          idx++;
        }
      }
      (void)a;
    }
    const uint8_t* ms = buf + off;
    for (uint64_t r = 0; r < rows; r++) {
      uint64_t bitpos = r * 5;
      uint64_t byte0 = bitpos >> 3;
      int shift = (int)(bitpos & 7);
      uint32_t w = ms[byte0];
      if (byte0 + 1 < mbytes) w |= (uint32_t)ms[byte0 + 1] << 8;
      uint32_t idx5 = (w >> shift) & 0x1F;
      if (idx5 >= 24) idx5 = idx5 % 24;
      // stored row packs dir-of-rank at 2-bit fields
      for (int rank = 0; rank < 4; rank++) {
        model_inv[r * 4 + rank] = perms[idx5][rank];
      }
    }
    off += mbytes;
  }

  // crc sections at the end
  const uint8_t* labels_crc_p = buf + n - 4 * (sz + 1);
  const uint8_t* crack_crcs = buf + n - 4 * sz;

  std::vector<uint64_t> z_off(sz + 1, off);
  for (int64_t z = 0; z < sz; z++) z_off[z + 1] = z_off[z] + z_len[z];
  (void)labels_crc_p;
  // crack payload + 4-byte labels crc + sz crack crcs must exactly
  // close the stream (z-index crc already verified above)
  if (z_off[sz] + 4 * (uint64_t)(sz + 1) != (uint64_t)n) return -1;

  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = hw ? (int64_t)hw : 1;
  if (n_threads > szr) n_threads = szr;
  if (n_threads < 1) n_threads = 1;

  std::vector<int64_t> rcs(n_threads, 0);

  auto worker = [&](int64_t t) {
  std::vector<uint8_t> vcg(sxy);
  std::vector<uint32_t> ccl(sxy);
  std::vector<uint8_t> cps;
  std::vector<int64_t> nodes;

  for (int64_t z = z0 + t; z < z1; z += n_threads) {
    const int64_t zi = z - z0;
    const uint8_t* code = buf + z_off[z];
    uint64_t clen = z_len[z];
    nodes.clear();
    cps.clear();

    if (clen > 0) {
      // BOC index; every cursor advance is bounds-checked so a
      // corrupt length prefix or count fails with -1 instead of
      // reading past the code span
      if (clen < 4) { rcs[t] = -1; return; }
      uint64_t index_size = 4 + rd(code, 4);
      if (index_size > clen) { rcs[t] = -1; return; }
      int xw = byte_width(h.sx + 1);
      int yw = byte_width(h.sy + 1);
      uint64_t p = 4;
      if (p + yw > index_size) { rcs[t] = -1; return; }
      uint64_t num_y = rd(code + p, yw); p += yw;
      uint64_t y = 0;
      for (uint64_t yi = 0; yi < num_y; yi++) {
        if (p + yw + xw > index_size) { rcs[t] = -1; return; }
        y += rd(code + p, yw); p += yw;
        uint64_t num_x = rd(code + p, xw); p += xw;
        if (num_x > (index_size - p) / (uint64_t)xw) {
          rcs[t] = -1; return;
        }
        uint64_t x = 0;
        for (uint64_t xi = 0; xi < num_x; xi++) {
          x += rd(code + p, xw); p += xw;
          nodes.push_back((int64_t)(x + (h.sx + 1) * y));
        }
      }

      if (h.markov_order > 0) {
        uint64_t rows = 1;
        for (int i = 0; i < h.markov_order; i++) rows *= 4;
        (void)rows;
        int64_t cap = (int64_t)(clen - index_size) * 8 + 2;
        cps.resize(cap);
        int64_t got = crackle_markov_decode(
          code + index_size, clen - index_size,
          model_inv.data(), h.markov_order, cps.data(), cap
        );
        if (got < 0) { rcs[t] = -1; return; }
        cps.resize(got);
      } else {
        // unpack 2-bit diffs + undiff
        uint64_t nb = clen - index_size;
        cps.resize(nb * 4);
        uint8_t acc = 0;
        for (uint64_t i = 0; i < nb; i++) {
          uint8_t b8 = code[index_size + i];
          for (int j = 0; j < 4; j++) {
            acc = (uint8_t)((acc + ((b8 >> (2 * j)) & 3)) & 3);
            cps[i * 4 + j] = acc;
          }
        }
      }
    }

    int64_t rc = crackle_replay_vcg(
      cps.data(), (int64_t)cps.size(), nodes.data(),
      (int64_t)nodes.size(), sx, sy, h.crack_format,
      [&]() {
        uint8_t base = h.crack_format ? 0 : 0b1111;
        std::fill(vcg.begin(), vcg.end(), base);
        return vcg.data();
      }()
    );
    if (rc < 0) { rcs[t] = -1; return; }

    int64_t N = crackle_ccl_vcg_slice(vcg.data(), sx, sy, ccl.data());
    if (N < 0) { rcs[t] = -1; return; }

    uint32_t stored = (uint32_t)rd(crack_crcs + 4 * z, 4);
    uint32_t computed = crc32c(
      reinterpret_cast<const uint8_t*>(ccl.data()), sxy * 4
    );
    if (stored != computed) { rcs[t] = -4; return; }

    // paint: per-slice component -> output label. Materialize the
    // slice's label window as a typed table once (N entries), then
    // the per-voxel loop is two typed loads — no per-voxel dynamic-
    // width decoding.
    uint64_t key_base = cum[z];
    uint64_t n_comp = cum[z + 1] - key_base;
    // the label table must carry exactly one key per decoded
    // component, each pointing inside uniq — a corrupt section that
    // survived the crc gates must fail, not read out of bounds
    if ((uint64_t)N != n_comp) { rcs[t] = -1; return; }
    std::vector<uint64_t> lmap(n_comp);
    for (uint64_t k = 0; k < n_comp; k++) {
      uint64_t key = rd(keys + (key_base + k) * kw, kw);
      if (key >= num_labels) { rcs[t] = -1; return; }
      lmap[k] = rd(uniq + key * h.stored_width, h.stored_width);
    }
    #define PAINT(OUT_T) do { \
      OUT_T* o = reinterpret_cast<OUT_T*>(out); \
      if (h.fortran_order) { \
        OUT_T* oz = o + zi * sxy; \
        for (int64_t i = 0; i < sxy; i++) { \
          oz[i] = (OUT_T)lmap[ccl[i]]; \
        } \
      } else { \
        for (int64_t yy2 = 0; yy2 < sy; yy2++) { \
          for (int64_t xx2 = 0; xx2 < sx; xx2++) { \
            int64_t i = xx2 + sx * yy2; \
            o[zi + szr * (yy2 + sy * xx2)] = (OUT_T)lmap[ccl[i]]; \
          } \
        } \
      } \
    } while (0)

    switch (h.data_width) {
      case 1: PAINT(uint8_t); break;
      case 2: PAINT(uint16_t); break;
      case 4: PAINT(uint32_t); break;
      case 8: PAINT(uint64_t); break;
      default: rcs[t] = -2; return;
    }
    #undef PAINT
  }
  };  // worker

  if (n_threads == 1) {
    worker(0);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int64_t t = 0; t < n_threads; t++) {
      pool.emplace_back(worker, t);
    }
    for (auto& th : pool) th.join();
  }
  for (int64_t t = 0; t < n_threads; t++) {
    if (rcs[t] != 0) return rcs[t];
  }

  return 0;
}


// Self-contained stream compressor (C ABI): flat labels, no markov,
// auto crack-format choice — the encode counterpart of
// crackle_decompress_stream, and the core of the wasm port
// (reference: wasm/crackle_wasm.cc compress entry; format assembly
// mirrors crackle.hpp:34-217 / labels.hpp:30-155 and is
// byte-identical to the python _encode_flat_fused pipeline).
// labels: width-byte little-endian voxels, FORTRAN flat order.
// Returns stream byte length, or -1 overflow / -2 bad width.
int64_t crackle_compress_stream(
  const void* labels, int32_t data_width,
  int64_t sx, int64_t sy, int64_t sz,
  int32_t fortran_order,
  uint8_t* out, int64_t out_cap
) {
  if (data_width != 1 && data_width != 2 && data_width != 4 &&
      data_width != 8) {
    return -2;
  }
  const int64_t sxy = sx * sy;
  const int64_t voxels = sxy * sz;

  // format choice: stored width from max label; permissible iff
  // fewer than half of consecutive F-order voxel pairs are equal
  uint64_t max_label = 0;
  int64_t num_pairs = 0;
  #define SCAN(T) do { \
    const T* L = reinterpret_cast<const T*>(labels); \
    for (int64_t i = 0; i < voxels; i++) { \
      if ((uint64_t)L[i] > max_label) max_label = (uint64_t)L[i]; \
      if (i > 0 && L[i] == L[i - 1]) num_pairs++; \
    } \
  } while (0)
  switch (data_width) {
    case 1: SCAN(uint8_t); break;
    case 2: SCAN(uint16_t); break;
    case 4: SCAN(uint32_t); break;
    case 8: SCAN(uint64_t); break;
  }
  #undef SCAN
  const int stored_width = byte_width(max_label);
  const bool permissible = (voxels > 0) && (num_pairs < voxels / 2);

  auto write_header = [&](uint64_t num_label_bytes) {
    out[0] = 'c'; out[1] = 'r'; out[2] = 'k'; out[3] = 'l';
    out[4] = 1;
    auto lg = [](int w) { return w == 1 ? 0 : w == 2 ? 1
                               : w == 4 ? 2 : 3; };
    uint16_t fmt = (uint16_t)(
      lg(data_width) | (lg(stored_width) << 2)
      | ((permissible ? 1 : 0) << 4) | (0 << 5)            // flat
      | ((fortran_order ? 1 : 0) << 7) | (0 << 8)          // unsigned
      | (0 << 9)                                           // markov 0
      | (0 << 13));                                        // sorted
    out[5] = (uint8_t)(fmt & 0xFF); out[6] = (uint8_t)(fmt >> 8);
    auto put32 = [&](int off, uint64_t v) {
      for (int i = 0; i < 4; i++) out[off + i] = (uint8_t)(v >> (8 * i));
    };
    put32(7, (uint64_t)sx); put32(11, (uint64_t)sy);
    put32(15, (uint64_t)sz);
    out[19] = 31;  // log2(grid_size): whole-slice grids
    for (int i = 0; i < 8; i++) {
      out[20 + i] = (uint8_t)(num_label_bytes >> (8 * i));
    }
    // crc8 poly 0xe7 init 0xFF over bytes [5, 28)
    uint8_t crc = 0xFF;
    for (int i = 5; i < 28; i++) {
      crc ^= out[i];
      for (int k = 0; k < 8; k++) {
        crc = (crc & 1) ? (uint8_t)((crc >> 1) ^ 0xe7)
                        : (uint8_t)(crc >> 1);
      }
    }
    out[28] = crc;
  };

  if (voxels == 0) {
    if (out_cap < 29) return -1;
    write_header(0);
    return 29;
  }

  // per-slice fused encode
  const int64_t n_corners = (sx + 1) * (sy + 1);
  const int64_t sym_cap = (16 * sxy + 64) > 4096 ? 16 * sxy + 64 : 4096;
  const int64_t cps_cap = sym_cap * 2;
  const int64_t max_chains = sxy + 8;
  const int64_t code_cap = cps_cap / 4 + 16 * max_chains + 64;
  std::vector<uint8_t> adj(n_corners), symbols(sym_cap), cps(cps_cap);
  std::vector<int64_t> nodes(max_chains), cp_lens(max_chains);
  std::vector<uint8_t> code(code_cap);
  std::vector<uint32_t> cc(sxy);
  std::vector<uint64_t> map_scratch(sxy);
  int64_t out_n = 0;

  std::vector<std::vector<uint8_t>> codes(sz);
  std::vector<uint32_t> crack_crcs(sz);
  std::vector<uint64_t> mapping;
  std::vector<uint64_t> nums(sz);
  for (int64_t z = 0; z < sz; z++) {
    const uint8_t* lz = reinterpret_cast<const uint8_t*>(labels)
                        + z * sxy * data_width;
    int64_t code_len = crackle_encode_slice(
      lz, data_width, sx, sy, permissible ? 1 : 0,
      adj.data(), symbols.data(), sym_cap, cps.data(), cps_cap,
      nodes.data(), cp_lens.data(), max_chains,
      code.data(), code_cap, cc.data(), map_scratch.data(), &out_n);
    if (code_len < 0) return code_len;
    codes[z].assign(code.data(), code.data() + code_len);
    crack_crcs[z] = crc32c(
      reinterpret_cast<const uint8_t*>(cc.data()), sxy * 4);
    nums[z] = (uint64_t)out_n;
    mapping.insert(mapping.end(), map_scratch.data(),
                   map_scratch.data() + out_n);
  }

  // global sorted unique + keys
  std::vector<uint64_t> uniq(mapping);
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
  const int key_width = byte_width((uint64_t)uniq.size());
  const int component_width = byte_width((uint64_t)sxy);

  const uint64_t num_label_bytes =
    8 + uniq.size() * stored_width + sz * component_width
    + mapping.size() * key_width;

  int64_t total = 29 + 4 * sz + 4 + (int64_t)num_label_bytes;
  for (int64_t z = 0; z < sz; z++) total += (int64_t)codes[z].size();
  total += 4 + 4 * sz;
  if (total > out_cap) return -1;

  write_header(num_label_bytes);
  uint8_t* w = out + 29;
  auto put = [&](uint64_t v, int width) {
    for (int i = 0; i < width; i++) {
      *w++ = (uint8_t)(v & 0xFF); v >>= 8;
    }
  };
  // z-index + crc
  uint8_t* zidx = w;
  for (int64_t z = 0; z < sz; z++) put((uint64_t)codes[z].size(), 4);
  put(crc32c(zidx, 4 * sz), 4);
  // labels section
  uint8_t* lstart = w;
  put(uniq.size(), 8);
  for (uint64_t u : uniq) put(u, stored_width);
  for (int64_t z = 0; z < sz; z++) put(nums[z], component_width);
  for (uint64_t m : mapping) {
    uint64_t k = (uint64_t)(std::lower_bound(uniq.begin(), uniq.end(),
                                             m) - uniq.begin());
    put(k, key_width);
  }
  uint32_t labels_crc = crc32c(lstart, (size_t)(w - lstart));
  // crack codes
  for (int64_t z = 0; z < sz; z++) {
    memcpy(w, codes[z].data(), codes[z].size());
    w += codes[z].size();
  }
  put(labels_crc, 4);
  for (int64_t z = 0; z < sz; z++) put(crack_crcs[z], 4);
  return w - out;
}

}  // extern "C"

// ---------------------------------------------------------------------
// the fast pin solver's pick order (pins encode)
// ---------------------------------------------------------------------

namespace {

// robin_hood::unordered_flat_set<uint32_t> as far as its iteration order
// goes: insert, erase and begin(), the same semantics as
// crackle_tpu_torch/ops/rh_set.py (murmur-style hash_int finalizer, 5
// info bits, 0.8 max load factor, info-increment halving, backward-shift
// deletion). Probe arithmetic runs in int64 where the stored info bytes
// are masked to 8 bits, as there.
struct RHSetU32 {
  static constexpr uint64_t kMult0 = 0xC4CEB9FE1A85EC53ULL;
  static constexpr uint64_t kMultStep = 0xC4CEB9FE1A85EC54ULL;
  uint64_t mult = kMult0;
  uint64_t mask = 0;
  std::vector<uint16_t> info = std::vector<uint16_t>(8, 0);
  std::vector<uint32_t> keys;
  int64_t n = 0, max_allowed = 0;
  int64_t info_inc = 32, info_shift = 0;

  static int64_t max_allowed_of(int64_t buckets) {
    return buckets * 80 / 100;
  }
  static int64_t buffered(int64_t buckets) {
    return buckets + std::min<int64_t>(max_allowed_of(buckets), 0xFF);
  }
  void init_data(int64_t buckets) {
    n = 0;
    mask = (uint64_t)(buckets - 1);
    max_allowed = max_allowed_of(buckets);
    int64_t nb = buffered(buckets);
    info.assign(nb + 1, 0);
    info[nb] = 1;  // sentinel
    keys.assign(nb + 1, 0);
    info_inc = 32;
    info_shift = 0;
  }
  static uint64_t hash_int(uint64_t x) {
    x ^= x >> 33;
    x *= 0xFF51AFD7ED558CCDULL;
    x ^= x >> 33;
    return x;
  }
  void key_to_idx(uint32_t key, int64_t& idx, int64_t& inf) const {
    uint64_t h = hash_int(key) * mult;
    h ^= h >> 33;
    inf = info_inc + (int64_t)((h & 31) >> info_shift);
    idx = (int64_t)((h >> 5) & mask);
  }
  void shift_up(int64_t start_idx, int64_t ins_idx) {
    std::memmove(&keys[ins_idx + 1], &keys[ins_idx],
                 (size_t)(start_idx - ins_idx) * sizeof(uint32_t));
    for (int64_t idx = start_idx; idx != ins_idx; --idx) {
      info[idx] = (uint16_t)((info[idx - 1] + info_inc) & 0xFF);
      if (info[idx] + info_inc > 0xFF) max_allowed = 0;
    }
  }
  void shift_down(int64_t idx) {
    while (info[idx + 1] >= 2 * info_inc) {
      info[idx] = (uint16_t)((info[idx + 1] - info_inc) & 0xFF);
      keys[idx] = keys[idx + 1];
      ++idx;
    }
    info[idx] = 0;
  }
  bool try_increase_info() {
    if (info_inc <= 2) return false;
    info_inc >>= 1;
    ++info_shift;
    int64_t nb = buffered((int64_t)mask + 1);
    for (int64_t i = 0; i < nb; ++i) info[i] >>= 1;
    info[nb] = 1;
    max_allowed = max_allowed_of((int64_t)mask + 1);
    return true;
  }
  bool insert_move(uint32_t key) {
    if (max_allowed == 0 && !try_increase_info()) return false;
    int64_t idx, inf;
    key_to_idx(key, idx, inf);
    while (inf <= info[idx]) {
      ++idx;
      inf += info_inc;
    }
    int64_t ins_idx = idx, ins_info = inf & 0xFF;
    if (ins_info + info_inc > 0xFF) max_allowed = 0;
    while (info[idx] != 0) ++idx;
    if (idx != ins_idx) shift_up(idx, ins_idx);
    info[ins_idx] = (uint16_t)ins_info;
    keys[ins_idx] = key;
    ++n;
    return true;
  }
  bool rehash(int64_t buckets) {
    std::vector<uint16_t> old_info = info;
    std::vector<uint32_t> old_keys = keys;
    int64_t old_nb = buffered((int64_t)mask + 1);
    init_data(buckets);
    for (int64_t i = 0; i < old_nb; ++i)
      if (old_info[i] != 0 && !insert_move(old_keys[i])) return false;
    return true;
  }
  bool increase_size() {
    if (mask == 0) {
      init_data(8);
      return true;
    }
    int64_t cap = max_allowed_of((int64_t)mask + 1);
    if (n < cap && try_increase_info()) return true;
    if (n * 2 < cap) {
      mult += kMultStep;  // pathological probing: a new multiplier
      return rehash((int64_t)mask + 1);
    }
    return rehash(((int64_t)mask + 1) * 2);
  }
  bool add(uint32_t key) {
    for (int attempt = 0; attempt < 256; ++attempt) {
      int64_t idx, inf;
      key_to_idx(key, idx, inf);
      while (inf < info[idx]) {
        ++idx;
        inf += info_inc;
      }
      while (inf == info[idx]) {
        if (keys[idx] == key) return true;
        ++idx;
        inf += info_inc;
      }
      if (n >= max_allowed) {
        if (!increase_size()) return false;
        continue;
      }
      int64_t ins_idx = idx, ins_info = inf;
      if (ins_info + info_inc > 0xFF) max_allowed = 0;
      while (info[idx] != 0) ++idx;
      if (idx != ins_idx) shift_up(idx, ins_idx);
      info[ins_idx] = (uint16_t)(ins_info & 0xFF);
      keys[ins_idx] = key;
      ++n;
      return true;
    }
    return false;
  }
  void discard(uint32_t key) {
    if (n == 0) return;
    int64_t idx, inf;
    key_to_idx(key, idx, inf);
    while (true) {
      if (inf == info[idx] && keys[idx] == key) {
        shift_down(idx);
        --n;
        return;
      }
      ++idx;
      inf += info_inc;
      if (inf > info[idx]) return;
    }
  }
};

}  // namespace

extern "C" {

// The fast pin solver's picks (pins.hpp find_suboptimal_pins), label by
// label: label j's components uni[uoff[j] .. uoff[j + 1]) (ascending) go
// into a robin-hood set; while it is not empty, the component in its
// first occupied bucket names a pin, choice[component], whose components
// cids[coff[k] .. coff[k + 1]) leave the set. picks (room for every
// component) receives the pins in pick order, npicks[j] their count per
// label. Returns the number of picks, -1 where the set overflows, -2
// where a picked component's pin does not cross it.
int64_t crackle_pins_pick(const uint32_t* uni, const int64_t* uoff,
                          int64_t nlabels, const int32_t* choice,
                          const int64_t* coff, const uint32_t* cids,
                          int32_t* picks, int64_t* npicks) {
  int64_t total = 0;
  for (int64_t j = 0; j < nlabels; ++j) {
    RHSetU32 rh;
    for (int64_t i = uoff[j]; i < uoff[j + 1]; ++i)
      if (!rh.add(uni[i])) return -1;
    // deletions shift entries down onto the freed bucket and never
    // below it, so the first occupied bucket only moves up
    int64_t first = 0, got = 0;
    while (rh.n) {
      while (rh.info[first] == 0) ++first;
      uint32_t key = rh.keys[first];
      int32_t k = choice[key];
      if (k < 0) return -2;
      for (int64_t q = coff[k]; q < coff[k + 1]; ++q) rh.discard(cids[q]);
      if (rh.info[first] != 0 && rh.keys[first] == key) return -2;
      picks[total + got++] = k;
    }
    npicks[j] = got;
    total += got;
  }
  return total;
}

}  // extern "C"
