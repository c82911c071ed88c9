// Native host-side columnar kernels for the query engine.
//
// The reference implements its entire ingest path in C++ (Table /
// TableRowWriter, base/infrastructure/table.cc; Arena-backed string
// storage, base/memory/arena.cc).  In this engine the device-side hot
// loops are XLA programs, but ingest — dictionary-encoding string
// columns and packing nullable host data — runs on the host CPU and is
// Python-loop-bound without this library.  Exposed via ctypes (no
// pybind11 in the image).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 fastcol.cpp -o libfastcol.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>
#include <vector>

extern "C" {

// Dictionary-encode a string column.
//
// Input: concatenated utf-8 bytes + (n+1) offsets delimiting n values,
// valid[i] = 0 marks NULL rows (their bytes are empty/ignored).
// Output: codes[i] = index of row i's value in the lexicographically
// sorted distinct-value list; returns the number of distinct values and
// fills dict_offsets (n_distinct+1 entries into the input byte space via
// representative row ids in dict_rows).
//
// The dictionary is order-preserving (sorted), matching
// supersonic_jax/dictionary.py's contract so ORDER BY on codes == ORDER
// BY on strings.
int64_t dict_encode(const char* bytes, const int64_t* offsets, int64_t n,
                    const uint8_t* valid, int32_t* codes,
                    int64_t* dict_rows /* size >= n */) {
  std::unordered_map<std::string_view, int32_t> first_row;
  first_row.reserve(static_cast<size_t>(n) * 2);
  std::vector<std::string_view> distinct;
  distinct.reserve(1024);
  std::vector<int32_t> provisional(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    if (valid && !valid[i]) {
      provisional[i] = -1;
      continue;
    }
    std::string_view sv(bytes + offsets[i],
                        static_cast<size_t>(offsets[i + 1] - offsets[i]));
    auto it = first_row.find(sv);
    if (it == first_row.end()) {
      int32_t id = static_cast<int32_t>(distinct.size());
      first_row.emplace(sv, id);
      distinct.push_back(sv);
      provisional[i] = id;
      dict_rows[id] = i;  // representative row for this distinct value
    } else {
      provisional[i] = it->second;
    }
  }
  // sort distinct values lexicographically; build old->new code remap
  int64_t n_distinct = static_cast<int64_t>(distinct.size());
  std::vector<int32_t> order(static_cast<size_t>(n_distinct));
  for (int64_t i = 0; i < n_distinct; ++i) order[i] = static_cast<int32_t>(i);
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return distinct[a] < distinct[b];
  });
  std::vector<int32_t> rank(static_cast<size_t>(n_distinct));
  std::vector<int64_t> rows_sorted(static_cast<size_t>(n_distinct));
  for (int64_t i = 0; i < n_distinct; ++i) {
    rank[order[i]] = static_cast<int32_t>(i);
    rows_sorted[i] = dict_rows[order[i]];
  }
  std::memcpy(dict_rows, rows_sorted.data(),
              static_cast<size_t>(n_distinct) * sizeof(int64_t));
  for (int64_t i = 0; i < n; ++i) {
    codes[i] = provisional[i] < 0 ? 0 : rank[provisional[i]];
  }
  return n_distinct;
}

// Gather rows of a fixed-width column by int32 indices (selection-vector
// materialization on host; the device path uses jnp.take).
void gather_fixed(const uint8_t* src, int64_t elem_size, const int32_t* idx,
                  int64_t n, uint8_t* dst) {
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(dst + i * elem_size, src + int64_t(idx[i]) * elem_size,
                static_cast<size_t>(elem_size));
  }
}

// Pack a nullable column given a value buffer with holes: writes 0 where
// invalid (deterministic padding), counts valid rows.
int64_t pack_nullable_f64(const double* vals, const uint8_t* valid,
                          int64_t n, double* out) {
  int64_t cnt = 0;
  for (int64_t i = 0; i < n; ++i) {
    bool ok = valid[i] != 0;
    out[i] = ok ? vals[i] : 0.0;
    cnt += ok;
  }
  return cnt;
}

int64_t pack_nullable_i64(const int64_t* vals, const uint8_t* valid,
                          int64_t n, int64_t* out) {
  int64_t cnt = 0;
  for (int64_t i = 0; i < n; ++i) {
    bool ok = valid[i] != 0;
    out[i] = ok ? vals[i] : 0;
    cnt += ok;
  }
  return cnt;
}

// Gather variable-length payloads by dictionary code: writes the
// concatenation of dict value bytes for each row (invalid rows contribute
// zero bytes).  `out` must be sized to the sum of per-row lengths, which
// the caller computes vectorized (dict length LUT gathered by codes).
// Backs the file-writer's string-column path (reference: file_io.cc:77-101
// lengths-then-concatenated-bytes layout).
void gather_blob(const char* dict_bytes, const int64_t* dict_offsets,
                 const int32_t* codes, const uint8_t* valid, int64_t n,
                 char* out) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (valid && !valid[i]) continue;
    int32_t c = codes[i];
    int64_t len = dict_offsets[c + 1] - dict_offsets[c];
    std::memcpy(out + pos, dict_bytes + dict_offsets[c],
                static_cast<size_t>(len));
    pos += len;
  }
}

// K-way merge of sorted runs by precomputed monotone row codes
// (reference: the external sort's final Merge, sort.cc:366-392, a k-way
// heap over row iterators via BoundMergeUnionAll).
//
// codes: n_total x m row-major uint64 lanes; ascending lexicographic
// order over a row's lanes == the desired output order (the caller folds
// DESC direction and NULL ranks into the lanes).  starts: k+1 offsets
// delimiting the k sorted runs inside the n_total rows.  out: n_total
// global row ids in merged order.  Stable across runs (ties emit the
// lower run first), matching the device merge's determinism contract
// (merge_union_all.cc:30-39).
void kway_merge_u64(const uint64_t* codes, int64_t m, const int64_t* starts,
                    int64_t k, int64_t* out) {
  struct Head {
    const uint64_t* key;  // current row's code lanes
    int64_t row;          // global row id
    int64_t end;          // run end (exclusive)
    int32_t run;          // run ordinal (tiebreak -> stable)
  };
  auto less = [m](const Head& a, const Head& b) {
    for (int64_t j = 0; j < m; ++j) {
      if (a.key[j] != b.key[j]) return a.key[j] < b.key[j];
    }
    return a.run < b.run;
  };
  // binary min-heap (manual: std::priority_queue is a max-heap and
  // copies comparators around; this keeps it tight)
  std::vector<Head> heap;
  heap.reserve(static_cast<size_t>(k));
  auto sift_up = [&](size_t i) {
    while (i > 0) {
      size_t p = (i - 1) / 2;
      if (!less(heap[i], heap[p])) break;
      std::swap(heap[i], heap[p]);
      i = p;
    }
  };
  auto sift_down = [&](size_t i) {
    size_t n = heap.size();
    for (;;) {
      size_t l = 2 * i + 1, r = l + 1, best = i;
      if (l < n && less(heap[l], heap[best])) best = l;
      if (r < n && less(heap[r], heap[best])) best = r;
      if (best == i) break;
      std::swap(heap[i], heap[best]);
      i = best;
    }
  };
  for (int64_t run = 0; run < k; ++run) {
    if (starts[run] < starts[run + 1]) {
      heap.push_back(Head{codes + starts[run] * m, starts[run],
                          starts[run + 1], static_cast<int32_t>(run)});
      sift_up(heap.size() - 1);
    }
  }
  int64_t pos = 0;
  while (!heap.empty()) {
    Head& h = heap[0];
    out[pos++] = h.row;
    if (++h.row < h.end) {
      h.key += m;
      sift_down(0);
    } else {
      heap[0] = heap.back();
      heap.pop_back();
      if (!heap.empty()) sift_down(0);
    }
  }
}

// CONCAT aggregation byte assembly (reference: aggregation_operators.h
// CONCAT functor, column_aggregator.cc:198-306): rows arrive already
// grouped (device sort by group key, original order within the group);
// for each of g groups this joins its non-null values with `sep`,
// optionally deduplicating values within the group (DISTINCT CONCAT).
// Two-pass ABI: pass out_bytes == nullptr to compute per-group lengths
// into out_lens[g] and return the total byte count; then call again with
// a buffer of that size to fill it.  codes: n int32 value-dictionary
// codes in grouped order; valid: n byte-bools (null = skip, no
// separator); group_starts: g+1 row offsets.
int64_t concat_groups(const char* dict_bytes, const int64_t* dict_offsets,
                      const int32_t* codes, const uint8_t* valid,
                      const int64_t* group_starts, int64_t g,
                      const char* sep, int64_t sep_len, uint8_t distinct,
                      int64_t* out_lens, char* out_bytes) {
  int64_t total = 0;
  std::vector<char> seen;  // per-group dedup bitmap over dictionary codes
  for (int64_t gi = 0; gi < g; ++gi) {
    int64_t len = 0;
    bool first = true;
    if (distinct) seen.assign(seen.size(), 0);
    for (int64_t r = group_starts[gi]; r < group_starts[gi + 1]; ++r) {
      if (valid != nullptr && !valid[r]) continue;
      int32_t c = codes[r];
      if (distinct) {
        if (static_cast<size_t>(c) >= seen.size()) seen.resize(c + 1, 0);
        if (seen[c]) continue;
        seen[c] = 1;
      }
      int64_t vlen = dict_offsets[c + 1] - dict_offsets[c];
      if (!first) {
        if (out_bytes != nullptr)
          std::memcpy(out_bytes + total + len, sep, sep_len);
        len += sep_len;
      }
      if (out_bytes != nullptr)
        std::memcpy(out_bytes + total + len, dict_bytes + dict_offsets[c],
                    vlen);
      len += vlen;
      first = false;
    }
    if (out_lens != nullptr) out_lens[gi] = first ? -1 : len;  // -1 = NULL
    total += len;
  }
  return total;
}

}  // extern "C"
