// parquet_codec: the byte-level pieces of the port's Parquet reader and
// writer (storage/parquet.py), built with the host C++ compiler and loaded
// with ctypes.
//
// - Snappy, the default codec of pyarrow's and DuckDB's writers: a decoder
//   of the whole format, and a simple greedy encoder (a 4-byte hash table,
//   copies with 2-byte offsets) whose output any Snappy decoder reads;
// - the RLE / bit-packed hybrid decoder of dictionary indices, definition
//   levels and RLE booleans;
// - PLAIN BYTE_ARRAY values (each a 4-byte length and its bytes) compacted
//   into one blob with offsets;
// - the sorted dictionary encoding of strings (host_strings.h).
//
// DuckDB vendors its own thrift and codecs for the same reason
// (extension/parquet): the machine with the card has no pyarrow.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "host_strings.h"

namespace {

inline uint32_t load32(const uint8_t *p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

void put_varint(std::vector<uint8_t> &o, uint64_t v) {
  while (v >= 0x80) {
    o.push_back(static_cast<uint8_t>(v | 0x80));
    v >>= 7;
  }
  o.push_back(static_cast<uint8_t>(v));
}

void put_literal(std::vector<uint8_t> &o, const uint8_t *p, size_t n) {
  size_t m = n - 1;
  if (m < 60) {
    o.push_back(static_cast<uint8_t>(m << 2));
  } else {
    int bytes = m < (1u << 8) ? 1 : m < (1u << 16) ? 2 : m < (1u << 24) ? 3 : 4;
    o.push_back(static_cast<uint8_t>((59 + bytes) << 2));
    for (int i = 0; i < bytes; ++i) o.push_back(static_cast<uint8_t>(m >> (8 * i)));
  }
  o.insert(o.end(), p, p + n);
}

void put_copy(std::vector<uint8_t> &o, size_t offset, size_t len) {
  while (len > 0) {  // copies of at most 64 bytes with 2-byte offsets
    size_t l = len > 64 ? 64 : len;
    o.push_back(static_cast<uint8_t>(((l - 1) << 2) | 2));
    o.push_back(static_cast<uint8_t>(offset));
    o.push_back(static_cast<uint8_t>(offset >> 8));
    len -= l;
  }
}

}  // namespace

extern "C" {

// -- Snappy ------------------------------------------------------------------------------

// the uncompressed length the stream's preamble states, or -1
long long snappy_length(const uint8_t *src, long long n) {
  uint64_t v = 0;
  for (int shift = 0, i = 0; i < n && shift < 64; ++i, shift += 7) {
    v |= static_cast<uint64_t>(src[i] & 0x7f) << shift;
    if (!(src[i] & 0x80)) return static_cast<long long>(v);
  }
  return -1;
}

// → bytes written to dst (its capacity cap), or -1 on a malformed stream
long long snappy_decompress(const uint8_t *src, long long n, uint8_t *dst, long long cap) {
  long long i = 0;
  while (i < n && (src[i] & 0x80)) ++i;
  ++i;  // past the preamble
  long long o = 0;
  while (i < n) {
    uint8_t tag = src[i++];
    long long len, off;
    switch (tag & 3) {
      case 0: {
        len = (tag >> 2) + 1;
        if (len > 60) {
          int bytes = static_cast<int>(len - 60);
          if (i + bytes > n) return -1;
          len = 0;
          for (int k = 0; k < bytes; ++k) len |= static_cast<long long>(src[i + k]) << (8 * k);
          len += 1;
          i += bytes;
        }
        if (i + len > n || o + len > cap) return -1;
        memcpy(dst + o, src + i, static_cast<size_t>(len));
        i += len;
        o += len;
        continue;
      }
      case 1:
        if (i >= n) return -1;
        len = ((tag >> 2) & 7) + 4;
        off = (static_cast<long long>(tag >> 5) << 8) | src[i++];
        break;
      case 2:
        if (i + 2 > n) return -1;
        len = (tag >> 2) + 1;
        off = src[i] | (static_cast<long long>(src[i + 1]) << 8);
        i += 2;
        break;
      default:
        if (i + 4 > n) return -1;
        len = (tag >> 2) + 1;
        off = static_cast<long long>(load32(src + i));
        i += 4;
    }
    if (off <= 0 || off > o || o + len > cap) return -1;
    if (off >= len) {
      memcpy(dst + o, dst + o - off, static_cast<size_t>(len));
    } else {
      for (long long k = 0; k < len; ++k) dst[o + k] = dst[o - off + k];
    }
    o += len;
  }
  return o;
}

long long snappy_max_compressed(long long n) { return 32 + n + n / 6; }

// → bytes written to dst (at least snappy_max_compressed(n) of room)
long long snappy_compress(const uint8_t *src, long long n, uint8_t *dst) {
  std::vector<uint8_t> o;
  o.reserve(static_cast<size_t>(n / 2 + 16));
  put_varint(o, static_cast<uint64_t>(n));
  const int kBits = 14;
  std::vector<int64_t> table(1 << kBits, -1);
  long long lit = 0, i = 0;
  while (i + 4 <= n) {
    uint32_t h = (load32(src + i) * 0x1e35a7bdu) >> (32 - kBits);
    int64_t cand = table[h];
    table[h] = i;
    if (cand >= 0 && i - cand <= 65535 && load32(src + cand) == load32(src + i)) {
      long long len = 4;
      while (i + len < n && src[cand + len] == src[i + len]) ++len;
      if (i > lit) put_literal(o, src + lit, static_cast<size_t>(i - lit));
      put_copy(o, static_cast<size_t>(i - cand), static_cast<size_t>(len));
      i += len;
      lit = i;
    } else {
      ++i;
    }
  }
  if (n > lit) put_literal(o, src + lit, static_cast<size_t>(n - lit));
  memcpy(dst, o.data(), o.size());
  return static_cast<long long>(o.size());
}

// -- the RLE / bit-packed hybrid ---------------------------------------------------------

// n values of bit_width bits from buf[0, len) into out → values decoded
// (fewer than n when the data ends first), or -1 if malformed
long long rle_hybrid_decode(const uint8_t *buf, long long len, int bit_width, long long n,
                            int32_t *out) {
  long long i = 0, got = 0;
  const int vbytes = (bit_width + 7) / 8;
  const uint64_t mask = bit_width >= 32 ? 0xffffffffu : ((1ull << bit_width) - 1);
  while (got < n && i < len) {
    uint64_t header = 0;
    int shift = 0;
    while (i < len) {
      uint8_t b = buf[i++];
      header |= static_cast<uint64_t>(b & 0x7f) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
      if (shift > 63) return -1;
    }
    if (header & 1) {  // bit-packed: groups of 8 values
      long long count = static_cast<long long>(header >> 1) * 8;
      long long bytes = static_cast<long long>(header >> 1) * bit_width;
      if (i + bytes > len) bytes = len - i;
      long long take = count < n - got ? count : n - got;
      for (long long k = 0; k < take; ++k) {
        long long bit = k * bit_width;
        long long byte = bit >> 3;
        if (bit_width == 0) {
          out[got + k] = 0;
          continue;
        }
        if ((bit + bit_width + 7) / 8 > bytes) return got + k;
        uint64_t w = 0;
        int nb = static_cast<int>(((bit & 7) + bit_width + 7) / 8);
        for (int b = 0; b < nb; ++b) w |= static_cast<uint64_t>(buf[i + byte + b]) << (8 * b);
        out[got + k] = static_cast<int32_t>((w >> (bit & 7)) & mask);
      }
      got += take;
      i += bytes;
    } else {  // a run of one value
      long long count = static_cast<long long>(header >> 1);
      if (i + vbytes > len) return -1;
      uint32_t v = 0;
      for (int b = 0; b < vbytes; ++b) v |= static_cast<uint32_t>(buf[i + b]) << (8 * b);
      i += vbytes;
      long long take = count < n - got ? count : n - got;
      for (long long k = 0; k < take; ++k) out[got + k] = static_cast<int32_t>(v);
      got += take;
    }
  }
  return got;
}

// -- PLAIN BYTE_ARRAY ------------------------------------------------------------------------

// n values (each a 4-byte little-endian length and its bytes) from
// buf[0, len) → bytes consumed, with the values' bytes in blob (room for
// len bytes) and offs (n + 1 entries, offs[0] = 0); -1 if malformed
long long plain_byte_arrays(const uint8_t *buf, long long len, long long n, uint8_t *blob,
                            int64_t *offs) {
  long long i = 0, o = 0;
  offs[0] = 0;
  for (long long k = 0; k < n; ++k) {
    if (i + 4 > len) return -1;
    long long l = load32(buf + i);
    i += 4;
    if (i + l > len) return -1;
    memcpy(blob + o, buf + i, static_cast<size_t>(l));
    i += l;
    o += l;
    offs[k + 1] = o;
  }
  return i;
}

// -- sorted dictionaries ---------------------------------------------------------------------

void *strings_encode(const char *blob, const int64_t *offs, long long n, int32_t *codes) {
  auto *d = new host_strings::Dict();
  host_strings::encode(blob, offs, n, nullptr, codes, d);
  return d;
}

long long strings_dict_size(void *h, long long *nbytes) {
  auto *d = static_cast<host_strings::Dict *>(h);
  *nbytes = static_cast<long long>(d->blob.size());
  return static_cast<long long>(d->offsets.size()) - 1;
}

void strings_dict(void *h, long long *offsets, char *blob) {
  auto *d = static_cast<host_strings::Dict *>(h);
  memcpy(offsets, d->offsets.data(), d->offsets.size() * 8);
  memcpy(blob, d->blob.data(), d->blob.size());
  delete d;
}

}  // extern "C"
