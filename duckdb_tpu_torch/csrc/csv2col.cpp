// csv2col: CSV text to typed columns, and typed columns to CSV text.
//
// The port's copy of the JAX package's tools/csv_loader/csv2col.cpp,
// built with the host C++ compiler into a shared library that
// storage/csv.py loads with ctypes (no intermediate directory). It keeps
// that tool's design (DuckDB's parallel CSV scanner in outline: one read
// of the file, byte ranges split at row boundaries, one thread per range)
// and adds what the engine's types need:
//
// - kinds for every integer width, FLOAT, BOOLEAN and TIMESTAMP;
// - DuckDB's NULL rule: an unquoted empty field is NULL, a quoted "" is
//   the empty string;
// - a configurable quote character, with a doubled quote as its escape,
//   and range splits that never fall inside a quoted field;
// - a value that does not parse as its column's kind stops the read and is
//   reported with its row and column (storage/csv.py raises
//   ConversionException with them);
// - VARCHAR columns come back dictionary-encoded (host_strings.h).
//
// The writer formats whole columns: numbers, DECIMAL at its scale, DATE and
// TIMESTAMP in ISO form, DOUBLE as Python's repr, BOOLEAN as True/False;
// a VARCHAR column arrives as codes into a dictionary whose values the
// caller has already quoted.

#include <algorithm>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

#include "host_strings.h"

namespace {

enum Kind {
  K_BOOL = 0, K_I8, K_I16, K_I32, K_I64, K_F32, K_F64, K_DATE, K_TS, K_DEC,
  K_STR, K_TSTZ
};

int days_from_civil(int64_t y, unsigned m, unsigned d) {
  y -= m <= 2;
  const int64_t era = (y >= 0 ? y : y - 399) / 400;
  const unsigned yoe = static_cast<unsigned>(y - era * 400);
  const unsigned doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return static_cast<int>(era * 146097 + static_cast<int64_t>(doe) - 719468);
}

void civil_from_days(int64_t z, int64_t *y, unsigned *m, unsigned *d) {
  z += 719468;
  const int64_t era = (z >= 0 ? z : z - 146096) / 146097;
  const unsigned doe = static_cast<unsigned>(z - era * 146097);
  const unsigned yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  const unsigned doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  const unsigned mp = (5 * doy + 2) / 153;
  *d = doy - (153 * mp + 2) / 5 + 1;
  *m = mp < 10 ? mp + 3 : mp - 9;
  *y = static_cast<int64_t>(yoe) + era * 400 + (*m <= 2);
}

bool leap(int64_t y) { return (y % 4 == 0 && y % 100 != 0) || y % 400 == 0; }

unsigned month_days(int64_t y, unsigned m) {
  static const unsigned days[] = {31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31};
  return m == 2 && leap(y) ? 29 : days[m - 1];
}

// -- parsing one field --------------------------------------------------------------

void trim(const char *&p, size_t &n) {
  while (n && (*p == ' ' || *p == '\t')) ++p, --n;
  while (n && (p[n - 1] == ' ' || p[n - 1] == '\t')) --n;
}

bool parse_int(const char *p, size_t n, int64_t lo, int64_t hi, int64_t *out) {
  trim(p, n);
  if (!n) return false;
  bool neg = false;
  if (*p == '+' || *p == '-') {
    neg = *p == '-';
    ++p, --n;
  }
  if (!n) return false;
  __int128 v = 0;
  for (size_t i = 0; i < n; ++i) {
    if (p[i] < '0' || p[i] > '9') return false;
    v = v * 10 + (p[i] - '0');
    if (v > (static_cast<__int128>(1) << 64)) return false;
  }
  if (neg) v = -v;
  if (v < lo || v > hi) return false;
  *out = static_cast<int64_t>(v);
  return true;
}

bool parse_double(const char *p, size_t n, double *out) {
  trim(p, n);
  if (!n || n > 400) return false;
  char buf[408];
  memcpy(buf, p, n);
  buf[n] = 0;
  for (size_t i = 0; i < n; ++i)
    if (buf[i] == 'x' || buf[i] == 'X') return false;  // no hex floats (Python's float())
  char *end = nullptr;
  errno = 0;
  double v = strtod(buf, &end);
  if (end != buf + n) return false;
  *out = v;
  return true;
}

// Exact decimal text → value scaled by 10^scale, rounded half away from zero
// on the first dropped digit (the JAX package's parse_decimal_text);
// exponent notation too. False when it is not a number or needs more than
// `width` digits.
bool parse_decimal(const char *p, size_t n, int scale, int width, int64_t *out) {
  trim(p, n);
  if (!n) return false;
  bool neg = false;
  if (*p == '+' || *p == '-') {
    neg = *p == '-';
    ++p, --n;
  }
  __int128 mant = 0;
  int frac = 0, digits = 0;
  bool dot = false, any = false;
  size_t i = 0;
  // digits past 36 significant ones are dropped (an integer digit still
  // counts toward the magnitude)
  int64_t extra_int = 0;
  for (; i < n; ++i) {
    char ch = p[i];
    if (ch == '.' && !dot) {
      dot = true;
      continue;
    }
    if (ch < '0' || ch > '9') break;
    any = true;
    if (digits < 36) {
      mant = mant * 10 + (ch - '0');
      if (mant) ++digits;
      if (dot) ++frac;
    } else if (!dot) {
      ++extra_int;
    }
  }
  if (!any) return false;
  int64_t exp = 0;
  if (i < n && (p[i] == 'e' || p[i] == 'E')) {
    if (!parse_int(p + i + 1, n - i - 1, -100000, 100000, &exp)) return false;
    i = n;
  }
  if (i != n) return false;
  int64_t shift = static_cast<int64_t>(scale) + exp - frac + extra_int;
  if (shift >= 0) {
    for (int64_t k = 0; k < shift; ++k) {
      mant *= 10;
      if (mant > (static_cast<__int128>(1) << 100)) return false;
    }
  } else {
    __int128 pw = 1;
    int64_t s = -shift;
    if (s > 38) {
      mant = 0;
    } else {
      for (int64_t k = 0; k < s; ++k) pw *= 10;
      __int128 q = mant / pw, r = mant % pw;
      if (r * 2 >= pw) ++q;
      mant = q;
    }
  }
  __int128 limit = 1;
  for (int k = 0; k < width; ++k) limit *= 10;
  if (mant >= limit || mant > INT64_MAX) return false;
  *out = neg ? -static_cast<int64_t>(mant) : static_cast<int64_t>(mant);
  return true;
}

bool parse_digits(const char *p, size_t n, int64_t *out) {
  int64_t v = 0;
  if (!n) return false;
  for (size_t i = 0; i < n; ++i) {
    if (p[i] < '0' || p[i] > '9') return false;
    v = v * 10 + (p[i] - '0');
  }
  *out = v;
  return true;
}

// YYYY-MM-DD (a year of 4 or more digits, an optional leading minus)
bool parse_date_part(const char *p, size_t n, size_t *used, int64_t *days) {
  size_t i = 0;
  bool neg = false;
  if (i < n && p[i] == '-') neg = true, ++i;
  size_t y0 = i;
  while (i < n && p[i] >= '0' && p[i] <= '9') ++i;
  if (i - y0 < 4 || i - y0 > 6 || i >= n || p[i] != '-') return false;
  int64_t y = 0, m, d;
  parse_digits(p + y0, i - y0, &y);
  if (neg) y = -y;
  if (i + 6 > n || p[i + 3] != '-') return false;
  if (!parse_digits(p + i + 1, 2, &m) || !parse_digits(p + i + 4, 2, &d)) return false;
  if (m < 1 || m > 12 || d < 1 || d > month_days(y, static_cast<unsigned>(m))) return false;
  *days = days_from_civil(y, static_cast<unsigned>(m), static_cast<unsigned>(d));
  *used = i + 6;
  return true;
}

bool parse_date(const char *p, size_t n, int64_t *out) {
  trim(p, n);
  size_t used;
  return parse_date_part(p, n, &used, out) && used == n;
}

// YYYY-MM-DD[( |T)HH:MM[:SS[.ffffff]]][Z|±HH[:MM]] → microseconds since the
// epoch (an offset is taken off, as DuckDB does)
bool parse_timestamp(const char *p, size_t n, int64_t *out) {
  trim(p, n);
  size_t i;
  int64_t days;
  if (!parse_date_part(p, n, &i, &days)) return false;
  int64_t us = 0;
  if (i < n && (p[i] == ' ' || p[i] == 'T')) {
    ++i;
    int64_t hh, mm, ss = 0;
    if (i + 5 > n || p[i + 2] != ':' || !parse_digits(p + i, 2, &hh) ||
        !parse_digits(p + i + 3, 2, &mm))
      return false;
    i += 5;
    if (i < n && p[i] == ':') {
      if (i + 3 > n || !parse_digits(p + i + 1, 2, &ss)) return false;
      i += 3;
    }
    if (hh > 24 || mm > 59 || ss > 59) return false;
    int64_t frac = 0, fd = 0;
    if (i < n && p[i] == '.') {
      ++i;
      while (i < n && p[i] >= '0' && p[i] <= '9') {
        if (fd < 6) frac = frac * 10 + (p[i] - '0'), ++fd;
        ++i;
      }
      for (; fd < 6; ++fd) frac *= 10;
    }
    us = ((hh * 60 + mm) * 60 + ss) * 1000000 + frac;
  }
  if (i < n && p[i] == ' ') ++i;
  if (i < n && (p[i] == 'Z' || p[i] == 'z')) {
    ++i;
  } else if (i < n && (p[i] == '+' || p[i] == '-')) {
    int sign = p[i] == '-' ? -1 : 1;
    int64_t oh, om = 0;
    if (i + 3 > n || !parse_digits(p + i + 1, 2, &oh)) return false;
    i += 3;
    if (i < n && p[i] == ':') ++i;
    if (i + 2 <= n && parse_digits(p + i, 2, &om)) i += 2;
    us -= sign * (oh * 60 + om) * 60 * 1000000;
  }
  if (i != n) return false;
  *out = days * 86400000000LL + us;
  return true;
}

bool parse_bool(const char *p, size_t n, int64_t *out) {
  trim(p, n);
  std::string s(p, n);
  for (auto &c : s) c = static_cast<char>(tolower(static_cast<unsigned char>(c)));
  if (s == "true" || s == "t" || s == "1") return *out = 1, true;
  if (s == "false" || s == "f" || s == "0") return *out = 0, true;
  return false;
}

// -- reading ---------------------------------------------------------------------------

struct Spec {
  int kind, scale, width;
};

struct Shard {
  std::vector<std::vector<int64_t>> num;     // one 8-byte slot per row (doubles bit-cast)
  std::vector<std::vector<int64_t>> soffs;   // string columns: row offsets
  std::vector<std::string> sblob;            // string columns: bytes
  std::vector<std::vector<uint8_t>> valid;
  int64_t rows = 0;
  bool failed = false;
  int64_t err_row = 0;
  int err_col = 0;
  std::string err_text;
};

struct Reader {
  std::vector<Spec> cols;
  int64_t rows = 0;
  std::vector<std::vector<int64_t>> num;
  std::vector<std::vector<uint8_t>> valid;
  std::vector<int64_t> nulls;
  std::vector<std::vector<int32_t>> codes;
  std::vector<host_strings::Dict> dicts;
  std::string error;
  int64_t err_row = -1;
  int err_col = -1;
};

struct Field {
  const char *p;
  size_t n;
  bool quoted;
};

class Tokenizer {
 public:
  Tokenizer(const char *data, size_t end, char delim, char quote)
      : d_(data), end_(end), delim_(delim), quote_(quote) {}

  // one field at pos; sets *eol when the row ends after it
  Field field(size_t &pos, bool *eol) {
    Field f{d_ + pos, 0, false};
    if (pos < end_ && d_[pos] == quote_) {
      f.quoted = true;
      size_t q0 = ++pos;
      bool plain = true;
      tmp_.clear();
      while (true) {
        const char *q = static_cast<const char *>(
            memchr(d_ + pos, quote_, end_ - pos));
        if (!q) {  // unterminated: the rest of the input
          tmp_.append(d_ + pos, end_ - pos);
          pos = end_;
          plain = false;
          break;
        }
        size_t at = static_cast<size_t>(q - d_);
        if (at + 1 < end_ && d_[at + 1] == quote_) {
          tmp_.append(d_ + pos, at + 1 - pos);
          pos = at + 2;
          plain = false;
          continue;
        }
        tmp_.append(d_ + pos, at - pos);
        pos = at + 1;
        break;
      }
      // text after the closing quote joins the field (Python's csv.reader)
      size_t s = pos;
      while (pos < end_ && d_[pos] != delim_ && d_[pos] != '\n' && d_[pos] != '\r') ++pos;
      if (pos > s) {
        tmp_.append(d_ + s, pos - s);
        plain = false;
      }
      if (plain) {
        f.p = d_ + q0;
        f.n = tmp_.size();
      } else {
        f.p = tmp_.data();
        f.n = tmp_.size();
      }
    } else {
      size_t s = pos;
      while (pos < end_ && d_[pos] != delim_ && d_[pos] != '\n' && d_[pos] != '\r') ++pos;
      f.p = d_ + s;
      f.n = pos - s;
    }
    if (pos < end_ && d_[pos] == delim_) {
      ++pos;
      *eol = false;
    } else {
      *eol = true;
    }
    return f;
  }

  void end_line(size_t &pos) {
    if (pos < end_ && d_[pos] == '\r') ++pos;
    if (pos < end_ && d_[pos] == '\n') ++pos;
  }

 private:
  const char *d_;
  size_t end_;
  char delim_, quote_;
  std::string tmp_;
};

bool convert(const Spec &s, const Field &f, int64_t *slot) {
  switch (s.kind) {
    case K_BOOL: return parse_bool(f.p, f.n, slot);
    case K_I8: return parse_int(f.p, f.n, -128, 127, slot);
    case K_I16: return parse_int(f.p, f.n, -32768, 32767, slot);
    case K_I32: return parse_int(f.p, f.n, INT32_MIN, INT32_MAX, slot);
    case K_I64: return parse_int(f.p, f.n, INT64_MIN, INT64_MAX, slot);
    case K_F32:
    case K_F64: {
      double v;
      if (!parse_double(f.p, f.n, &v)) return false;
      memcpy(slot, &v, 8);
      return true;
    }
    case K_DATE: return parse_date(f.p, f.n, slot);
    case K_TS:
    case K_TSTZ: return parse_timestamp(f.p, f.n, slot);
    case K_DEC: return parse_decimal(f.p, f.n, s.scale, s.width, slot);
  }
  return false;
}

void parse_range(const char *data, size_t begin, size_t end, const std::vector<Spec> &cols,
                 char delim, char quote, Shard *out) {
  const size_t ncol = cols.size();
  out->num.resize(ncol);
  out->soffs.resize(ncol);
  out->sblob.resize(ncol);
  out->valid.resize(ncol);
  for (size_t c = 0; c < ncol; ++c)
    if (cols[c].kind == K_STR) out->soffs[c].push_back(0);
  Tokenizer tok(data, end, delim, quote);
  size_t pos = begin;
  while (pos < end) {
    if (data[pos] == '\n' || data[pos] == '\r') {  // an empty line holds no row
      tok.end_line(pos);
      continue;
    }
    bool eol = false;
    for (size_t c = 0; c < ncol; ++c) {
      Field f{nullptr, 0, false};
      bool present = !eol;
      if (present) f = tok.field(pos, &eol);
      bool null = !present || (!f.quoted && f.n == 0);
      out->valid[c].push_back(null ? 0 : 1);
      if (cols[c].kind == K_STR) {
        if (!null) out->sblob[c].append(f.p, f.n);
        out->soffs[c].push_back(static_cast<int64_t>(out->sblob[c].size()));
        continue;
      }
      int64_t slot = 0;
      if (!null && !convert(cols[c], f, &slot)) {
        out->failed = true;
        out->err_row = out->rows;
        out->err_col = static_cast<int>(c);
        out->err_text.assign(f.p, std::min<size_t>(f.n, 200));
        return;
      }
      out->num[c].push_back(slot);
    }
    while (!eol) {  // fields past the last column are dropped
      tok.field(pos, &eol);
    }
    tok.end_line(pos);
    ++out->rows;
  }
}

// the first row start at or after `target` that is outside quotes, given the
// quote parity at `from`
size_t row_start_after(const char *data, size_t size, char quote, size_t &scan,
                       bool &inq, size_t target) {
  // advance the parity to target
  while (true) {
    const char *q = static_cast<const char *>(memchr(data + scan, quote, size - scan));
    size_t at = q ? static_cast<size_t>(q - data) : size;
    if (at >= target) break;
    inq = !inq;
    scan = at + 1;
  }
  size_t pos = target;
  while (pos < size) {
    const char *nl = static_cast<const char *>(memchr(data + pos, '\n', size - pos));
    size_t at = nl ? static_cast<size_t>(nl - data) : size;
    // quotes between pos and the newline flip the parity
    while (true) {
      const char *q = static_cast<const char *>(memchr(data + scan, quote, size - scan));
      size_t qa = q ? static_cast<size_t>(q - data) : size;
      if (qa >= at) break;
      inq = !inq;
      scan = qa + 1;
    }
    if (at >= size) return size;
    if (!inq) {
      if (scan < at + 1) scan = at + 1;
      return at + 1;
    }
    pos = at + 1;
    if (scan < pos) scan = pos;
  }
  return size;
}

}  // namespace

extern "C" {

void *csv2col_read(const char *path, int ncol, const int *kinds, const int *scales,
                   const int *widths, char delim, char quote, int header, int nthreads) {
  Reader *r = new Reader();
  for (int c = 0; c < ncol; ++c) r->cols.push_back({kinds[c], scales[c], widths[c]});
  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    r->error = std::string("cannot open ") + path + ": " + strerror(errno);
    return r;
  }
  struct stat st;
  fstat(fd, &st);
  size_t size = static_cast<size_t>(st.st_size);
  std::vector<char> buf(size + 1);
  size_t off = 0;
  while (off < size) {
    ssize_t got = read(fd, buf.data() + off, size - off);
    if (got <= 0) break;
    off += static_cast<size_t>(got);
  }
  close(fd);
  size = off;
  const char *data = buf.data();
  size_t begin = 0;
  if (size >= 3 && memcmp(data, "\xEF\xBB\xBF", 3) == 0) begin = 3;  // a UTF-8 byte order mark
  size_t scan = begin;
  bool inq = false;
  if (header) begin = row_start_after(data, size, quote, scan, inq, begin);
  if (nthreads < 1 || size - begin < (1u << 20)) nthreads = 1;
  std::vector<size_t> bounds{begin};
  for (int t = 1; t < nthreads; ++t) {
    size_t target = begin + (size - begin) * static_cast<size_t>(t) / nthreads;
    target = std::max(target, bounds.back());
    bounds.push_back(row_start_after(data, size, quote, scan, inq, target));
  }
  bounds.push_back(size);
  std::vector<Shard> shards(nthreads);
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t)
    threads.emplace_back(parse_range, data, bounds[t], bounds[t + 1], std::cref(r->cols),
                         delim, quote, &shards[t]);
  for (auto &th : threads) th.join();
  int64_t before = 0;
  for (auto &s : shards) {
    if (s.failed) {
      r->err_row = before + s.err_row;
      r->err_col = s.err_col;
      r->error = s.err_text;
      return r;
    }
    before += s.rows;
  }
  r->rows = before;
  r->num.resize(ncol);
  r->valid.resize(ncol);
  r->nulls.assign(ncol, 0);
  r->codes.resize(ncol);
  r->dicts.resize(ncol);
  std::vector<std::thread> enc;
  for (int c = 0; c < ncol; ++c) {
    auto &valid = r->valid[c];
    valid.reserve(r->rows);
    for (auto &s : shards) valid.insert(valid.end(), s.valid[c].begin(), s.valid[c].end());
    for (uint8_t v : valid) r->nulls[c] += !v;
    if (r->cols[c].kind != K_STR) {
      auto &num = r->num[c];
      num.reserve(r->rows);
      for (auto &s : shards) {
        num.insert(num.end(), s.num[c].begin(), s.num[c].end());
        std::vector<int64_t>().swap(s.num[c]);
      }
      continue;
    }
    // the shards' strings as one blob, then each string column encoded on
    // a thread of its own
    enc.emplace_back([r, c, &shards]() {
      std::string blob;
      std::vector<int64_t> offs{0};
      for (auto &s : shards) {
        int64_t base = static_cast<int64_t>(blob.size());
        blob.append(s.sblob[c]);
        for (size_t i = 1; i < s.soffs[c].size(); ++i) offs.push_back(base + s.soffs[c][i]);
      }
      r->codes[c].resize(r->rows);
      host_strings::encode(blob.data(), offs.data(), r->rows, r->valid[c].data(),
                           r->codes[c].data(), &r->dicts[c]);
    });
  }
  for (auto &th : enc) th.join();
  return r;
}

const char *csv2col_error(void *h, long long *row, int *col) {
  Reader *r = static_cast<Reader *>(h);
  *row = r->err_row;
  *col = r->err_col;
  return r->error.c_str();
}

long long csv2col_rows(void *h) { return static_cast<Reader *>(h)->rows; }

long long csv2col_nulls(void *h, int c) { return static_cast<Reader *>(h)->nulls[c]; }

// the column's values at its kind's width (codes for a string column), and
// its validity bytes
void csv2col_fetch(void *h, int c, void *values, unsigned char *valid) {
  Reader *r = static_cast<Reader *>(h);
  const int64_t n = r->rows;
  memcpy(valid, r->valid[c].data(), static_cast<size_t>(n));
  const auto &num = r->num[c];
  switch (r->cols[c].kind) {
    case K_STR:
      memcpy(values, r->codes[c].data(), static_cast<size_t>(n) * 4);
      break;
    case K_BOOL:
      for (int64_t i = 0; i < n; ++i) static_cast<uint8_t *>(values)[i] = num[i] != 0;
      break;
    case K_I8:
      for (int64_t i = 0; i < n; ++i) static_cast<int8_t *>(values)[i] = static_cast<int8_t>(num[i]);
      break;
    case K_I16:
      for (int64_t i = 0; i < n; ++i) static_cast<int16_t *>(values)[i] = static_cast<int16_t>(num[i]);
      break;
    case K_I32:
    case K_DATE:
      for (int64_t i = 0; i < n; ++i) static_cast<int32_t *>(values)[i] = static_cast<int32_t>(num[i]);
      break;
    case K_F32:
      for (int64_t i = 0; i < n; ++i) {
        double v;
        memcpy(&v, &num[i], 8);
        static_cast<float *>(values)[i] = static_cast<float>(v);
      }
      break;
    default:  // i64, f64, timestamps, decimals: 8 bytes a row
      memcpy(values, num.data(), static_cast<size_t>(n) * 8);
  }
}

long long csv2col_dict_size(void *h, int c, long long *nbytes) {
  Reader *r = static_cast<Reader *>(h);
  *nbytes = static_cast<long long>(r->dicts[c].blob.size());
  return static_cast<long long>(r->dicts[c].offsets.size()) - 1;
}

void csv2col_dict(void *h, int c, long long *offsets, char *blob) {
  Reader *r = static_cast<Reader *>(h);
  const auto &d = r->dicts[c];
  memcpy(offsets, d.offsets.data(), d.offsets.size() * 8);
  memcpy(blob, d.blob.data(), d.blob.size());
}

void csv2col_free(void *h) { delete static_cast<Reader *>(h); }

}  // extern "C"

// -- writing -------------------------------------------------------------------------------

namespace {

// digits by hand: snprintf costs more than the rest of a row
void put_uint(std::string &o, unsigned long long v, int width = 1) {
  char b[24];
  int n = 0;
  do {
    b[23 - n++] = static_cast<char>('0' + v % 10);
    v /= 10;
  } while (v);
  while (n < width && n < 24) b[23 - n++] = '0';
  o.append(b + 24 - n, static_cast<size_t>(n));
}

void put_int(std::string &o, int64_t v) {
  if (v < 0) o.push_back('-');
  put_uint(o, v < 0 ? 0ULL - static_cast<unsigned long long>(v)
                    : static_cast<unsigned long long>(v));
}

void put_pad(std::string &o, int64_t v, int width) {
  if (v < 0) {
    o.push_back('-');
    put_uint(o, 0ULL - static_cast<unsigned long long>(v), width - 1);
  } else {
    put_uint(o, static_cast<unsigned long long>(v), width);
  }
}

// Python's repr(float): the shortest digits that read back to the same
// double, in fixed notation unless the exponent is below -4 or above 15
void put_double(std::string &o, double v) {
  if (std::isnan(v)) return o.append("nan"), void();
  if (std::isinf(v)) return o.append(v < 0 ? "-inf" : "inf"), void();
  if (v == 0) return o.append(std::signbit(v) ? "-0.0" : "0.0"), void();
  char b[40];
  int prec = 1;
  for (; prec <= 17; ++prec) {
    snprintf(b, sizeof b, "%.*e", prec - 1, v);
    if (strtod(b, nullptr) == v) break;
  }
  // b = [-]d[.ddd]e±XX
  std::string s(b);
  bool neg = s[0] == '-';
  if (neg) s.erase(0, 1);
  size_t e = s.find('e');
  int exp = atoi(s.c_str() + e + 1);
  std::string digits;
  for (size_t i = 0; i < e; ++i)
    if (s[i] != '.') digits.push_back(s[i]);
  while (digits.size() > 1 && digits.back() == '0') digits.pop_back();
  int decpt = exp + 1;
  const int nd = static_cast<int>(digits.size());
  if (neg) o.push_back('-');
  if (decpt <= -4 || decpt > 16) {
    o.push_back(digits[0]);
    if (nd > 1) {
      o.push_back('.');
      o.append(digits, 1, std::string::npos);
    }
    char eb[16];
    snprintf(eb, sizeof eb, "e%c%02d", decpt - 1 < 0 ? '-' : '+', std::abs(decpt - 1));
    o.append(eb);
  } else if (decpt <= 0) {
    o.append("0.");
    o.append(static_cast<size_t>(-decpt), '0');
    o.append(digits);
  } else if (decpt >= nd) {
    o.append(digits);
    o.append(static_cast<size_t>(decpt - nd), '0');
    o.append(".0");
  } else {
    o.append(digits, 0, static_cast<size_t>(decpt));
    o.push_back('.');
    o.append(digits, static_cast<size_t>(decpt), std::string::npos);
  }
}

void put_date(std::string &o, int64_t days) {
  int64_t y;
  unsigned m, d;
  civil_from_days(days, &y, &m, &d);
  put_pad(o, y, 4);
  o.push_back('-');
  put_pad(o, m, 2);
  o.push_back('-');
  put_pad(o, d, 2);
}

// str(datetime): the seconds' fraction only where it is not zero
void put_timestamp(std::string &o, int64_t us) {
  int64_t days = us >= 0 ? us / 86400000000LL : -((-us + 86400000000LL - 1) / 86400000000LL);
  int64_t rest = us - days * 86400000000LL;
  put_date(o, days);
  o.push_back(' ');
  put_pad(o, rest / 3600000000LL, 2);
  o.push_back(':');
  put_pad(o, rest / 60000000LL % 60, 2);
  o.push_back(':');
  put_pad(o, rest / 1000000 % 60, 2);
  if (rest % 1000000) {
    o.push_back('.');
    put_pad(o, rest % 1000000, 6);
  }
}

void put_decimal(std::string &o, int64_t v, int scale) {
  if (!scale) return put_int(o, v);
  unsigned long long a = v < 0 ? 0ULL - static_cast<unsigned long long>(v)
                                : static_cast<unsigned long long>(v);
  unsigned long long p = 1;
  for (int i = 0; i < scale; ++i) p *= 10;
  if (v < 0) o.push_back('-');
  put_uint(o, a / p);
  o.push_back('.');
  put_uint(o, a % p, scale);
}

}  // namespace

extern "C" {

// rows [0, nrows) of the columns as CSV text after `head` (the header line,
// or nothing), each row ended by "\r\n" as Python's csv.writer ends it.
// values[c]: the column's plane at its kind's width; valid[c]: bytes, or
// null when every row is valid; for K_STR, codes into the dictionary
// dict_offsets[c] / dict_blobs[c], whose values are already quoted. → 0, or
// -1 with errno's message in err
int csv2col_write(const char *path, const char *head, long long head_len, int ncol,
                  const int *kinds, const int *scales, const void *const *values,
                  const unsigned char *const *valid, const long long *const *dict_offsets,
                  const char *const *dict_blobs, long long nrows, char delim, char *err,
                  int errlen) {
  FILE *f = fopen(path, "wb");
  if (!f) {
    snprintf(err, static_cast<size_t>(errlen), "%s: %s", path, strerror(errno));
    return -1;
  }
  std::string o;
  o.reserve(1 << 22);
  o.append(head, static_cast<size_t>(head_len));
  for (long long i = 0; i < nrows; ++i) {
    for (int c = 0; c < ncol; ++c) {
      if (c) o.push_back(delim);
      if (valid[c] && !valid[c][i]) continue;
      const void *v = values[c];
      switch (kinds[c]) {
        case K_BOOL: o.append(static_cast<const uint8_t *>(v)[i] ? "True" : "False"); break;
        case K_I8: put_int(o, static_cast<const int8_t *>(v)[i]); break;
        case K_I16: put_int(o, static_cast<const int16_t *>(v)[i]); break;
        case K_I32: put_int(o, static_cast<const int32_t *>(v)[i]); break;
        case K_I64: put_int(o, static_cast<const int64_t *>(v)[i]); break;
        case K_F32: put_double(o, static_cast<const float *>(v)[i]); break;
        case K_F64: put_double(o, static_cast<const double *>(v)[i]); break;
        case K_DATE: put_date(o, static_cast<const int32_t *>(v)[i]); break;
        case K_TS: put_timestamp(o, static_cast<const int64_t *>(v)[i]); break;
        case K_TSTZ:
          put_timestamp(o, static_cast<const int64_t *>(v)[i]);
          o.append("+00:00");
          break;
        case K_DEC: put_decimal(o, static_cast<const int64_t *>(v)[i], scales[c]); break;
        case K_STR: {
          int32_t code = static_cast<const int32_t *>(v)[i];
          const long long *offs = dict_offsets[c];
          o.append(dict_blobs[c] + offs[code], static_cast<size_t>(offs[code + 1] - offs[code]));
          break;
        }
      }
    }
    o.append("\r\n");
    if (o.size() >= (1u << 22)) {
      if (fwrite(o.data(), 1, o.size(), f) != o.size()) break;
      o.clear();
    }
  }
  bool ok = fwrite(o.data(), 1, o.size(), f) == o.size();
  ok = (fclose(f) == 0) && ok;
  if (!ok) {
    snprintf(err, static_cast<size_t>(errlen), "%s: %s", path, strerror(errno));
    return -1;
  }
  return 0;
}

}  // extern "C"
