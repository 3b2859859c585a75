// Sorted dictionary encoding of byte strings, shared by the host libraries
// csv2col.cpp and parquet_codec.cpp.
//
// The engine keeps a VARCHAR column as int32 codes into a dictionary sorted
// by value (storage/binary_dir.dict_encode gives the same with np.unique).
// UTF-8 byte order is code point order, so sorting the raw bytes with
// memcmp gives the order of Python's str comparison.

#pragma once

#include <algorithm>
#include <cstdint>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace host_strings {

struct Dict {
  std::vector<int64_t> offsets;  // n + 1 byte offsets into blob
  std::string blob;
};

// values[i] = blob[offs[i], offs[i + 1]); rows with valid[i] == 0 (when
// valid is given) take code 0 and add nothing. An empty dictionary gets
// one empty value, so that a code always has a value to name.
inline void encode(const char *blob, const int64_t *offs, int64_t n,
                   const uint8_t *valid, int32_t *codes, Dict *out) {
  std::unordered_map<std::string_view, int32_t> ids;
  ids.reserve(static_cast<size_t>(std::min<int64_t>(n, 1 << 22)) + 1);
  std::vector<std::string_view> uniq;
  for (int64_t i = 0; i < n; ++i) {
    if (valid && !valid[i]) {
      codes[i] = -1;
      continue;
    }
    std::string_view v(blob + offs[i], static_cast<size_t>(offs[i + 1] - offs[i]));
    auto it = ids.find(v);
    if (it == ids.end()) {
      int32_t id = static_cast<int32_t>(uniq.size());
      ids.emplace(v, id);
      uniq.push_back(v);
      codes[i] = id;
    } else {
      codes[i] = it->second;
    }
  }
  if (uniq.empty()) uniq.push_back(std::string_view());
  std::vector<int32_t> order(uniq.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = static_cast<int32_t>(i);
  std::sort(order.begin(), order.end(),
            [&](int32_t a, int32_t b) { return uniq[a] < uniq[b]; });
  std::vector<int32_t> rank(uniq.size());
  size_t total = 0;
  for (size_t r = 0; r < order.size(); ++r) {
    rank[order[r]] = static_cast<int32_t>(r);
    total += uniq[order[r]].size();
  }
  for (int64_t i = 0; i < n; ++i) codes[i] = codes[i] < 0 ? 0 : rank[codes[i]];
  out->offsets.assign(order.size() + 1, 0);
  out->blob.clear();
  out->blob.reserve(total);
  for (size_t r = 0; r < order.size(); ++r) {
    out->blob.append(uniq[order[r]]);
    out->offsets[r + 1] = static_cast<int64_t>(out->blob.size());
  }
}

}  // namespace host_strings
