// Native host-side pattern compiler for pfac-tpu.
//
// Equivalent of the reference's C++ host compiler
// (reference: PFAC/src/PFAC_reorder_Table.cpp:121-329 — parser, sort,
// trie builder), re-designed for this framework's table formats:
//   * pfac_compile: pattern buffer -> sorted order, IDs, trie edge list
//
// Exposed as a plain C ABI consumed via ctypes (core/native.py). The
// Python implementations remain as the behavioral oracle; differential
// tests enforce bit-identical outputs.
//
// Build: g++ -O2 -shared -fPIC -o libpfac_host.so pfac_host.cpp

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// pattern parsing + reordering + trie construction
// ---------------------------------------------------------------------------

struct PfacCompileResult {
  // trie edges in insertion order: (state, ch, next) triplets
  int32_t* edges;
  int64_t num_edges;
  // per sorted-index pattern info
  int32_t* pat_offset;  // byte offset of pattern start in the input buffer
  int32_t* pat_id;      // original 1-based pattern ID
  int32_t* pat_len_by_id;  // [k+1], entry 0 unused
  int32_t num_patterns;
  int32_t num_states;
  int32_t initial_state;
  int32_t num_leaves;
  int32_t status;  // 0 ok
};

static int32_t* copy_vec(const std::vector<int32_t>& v) {
  int32_t* p = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * std::max<size_t>(1, v.size())));
  if (p) std::memcpy(p, v.data(), sizeof(int32_t) * v.size());
  return p;
}

// Parse newline-delimited patterns from `data`, assign IDs by file order of
// non-empty lines, ignore a trailing unterminated line, sort prefix-first
// lexicographic (stable), and build the failureless-AC trie with the
// reference's state numbering: finals 1..k, initial k+1, interior k+2...
PfacCompileResult* pfac_compile(const uint8_t* data, int64_t size) {
  auto* res = static_cast<PfacCompileResult*>(std::calloc(1, sizeof(PfacCompileResult)));
  if (!res) return nullptr;

  // ---- parse
  struct Pat { int64_t off; int32_t len; int32_t id; };
  std::vector<Pat> pats;
  int64_t start = 0;
  for (int64_t i = 0; i < size; ++i) {
    if (data[i] == '\n') {
      if (i > start) {
        pats.push_back({start, static_cast<int32_t>(i - start),
                        static_cast<int32_t>(pats.size() + 1)});
      }
      start = i + 1;
    }
  }
  const int32_t k = static_cast<int32_t>(pats.size());
  if (k == 0) { res->status = 1; return res; }

  // ---- stable sort, prefix-first lexicographic (== bytewise less)
  std::stable_sort(pats.begin(), pats.end(), [&](const Pat& a, const Pat& b) {
    const int32_t n = std::min(a.len, b.len);
    const int c = std::memcmp(data + a.off, data + b.off, static_cast<size_t>(n));
    if (c != 0) return c < 0;
    return a.len < b.len;
  });

  // ---- trie build (reference semantics; duplicate final edges replaced)
  const int32_t initial_state = k + 1;
  int32_t state_num = initial_state + 1;
  // per-state adjacency: insertion-ordered edge list + map for O(1) lookup
  std::vector<std::vector<std::pair<int32_t, int32_t>>> rows(2 * (k + 2));
  std::vector<std::unordered_map<int32_t, int32_t>> maps(rows.size());
  auto ensure = [&](int32_t s) {
    if (static_cast<size_t>(s) >= rows.size()) {
      rows.resize(s + 64);
      maps.resize(rows.size());
    }
  };
  ensure(initial_state);

  for (const Pat& p : pats) {
    int32_t state = initial_state;
    for (int32_t o = 0; o < p.len; ++o) {
      const int32_t ch = data[p.off + o];
      ensure(state);
      if (o == p.len - 1) {
        auto it = maps[state].find(ch);
        if (it != maps[state].end()) {
          // duplicate pattern: replace edge target in place (last ID wins,
          // matching the reference's dense-table overwrite order)
          for (auto& e : rows[state])
            if (e.first == ch) e.second = p.id;
          it->second = p.id;
        } else {
          rows[state].push_back({ch, p.id});
          maps[state][ch] = p.id;
        }
      } else {
        auto it = maps[state].find(ch);
        if (it == maps[state].end()) {
          rows[state].push_back({ch, state_num});
          maps[state][ch] = state_num;
          state = state_num++;
        } else {
          state = it->second;
        }
      }
    }
  }

  // ---- emit
  std::vector<int32_t> edges;
  for (int32_t s = 0; s < state_num; ++s) {
    for (auto& e : rows[s]) {
      edges.push_back(s);
      edges.push_back(e.first);
      edges.push_back(e.second);
    }
  }
  std::vector<int32_t> off(k), ids(k), lens(k + 1, 0);
  int32_t leaves = 0;
  for (int32_t i = 0; i < k; ++i) {
    off[i] = static_cast<int32_t>(pats[i].off);
    ids[i] = pats[i].id;
    lens[pats[i].id] = pats[i].len;
  }
  for (int32_t s = 1; s <= k; ++s)
    if (static_cast<size_t>(s) >= rows.size() || rows[s].empty()) ++leaves;

  res->edges = copy_vec(edges);
  res->num_edges = static_cast<int64_t>(edges.size() / 3);
  res->pat_offset = copy_vec(off);
  res->pat_id = copy_vec(ids);
  res->pat_len_by_id = copy_vec(lens);
  res->num_patterns = k;
  res->num_states = state_num;
  res->initial_state = initial_state;
  res->num_leaves = leaves;
  res->status = 0;
  return res;
}

void pfac_compile_free(PfacCompileResult* r) {
  if (!r) return;
  std::free(r->edges);
  std::free(r->pat_offset);
  std::free(r->pat_id);
  std::free(r->pat_len_by_id);
  std::free(r);
}

int pfac_host_abi_version() { return 3; }

}  // extern "C"
