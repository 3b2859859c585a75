/* duckdb_tpu_torch C API implementation: calls the port through CPython.
 *
 * A copy of the JAX package's (duckdb_tpu/capi/capi.cpp), changed where
 * the port differs: the bridge module is duckdb_tpu_torch.capi.bridge, a
 * connection opens on CUDA unless a "device" config entry names another
 * device, and duckdb_disconnect closes the port's connection (the last
 * close of a file database checkpoints it). It follows DuckDB's C API
 * semantics (src/main/capi/, src/include/duckdb.h) for the embedding
 * lifecycle. Query results are materialized once into C++-owned columnar
 * buffers (per column: null bitmap + int64 / double / std::string plane),
 * so value accessors are plain memory reads — no Python re-entry, no GIL.
 * Data chunks expose width-faithful typed planes (INTEGER -> int32_t*,
 * VARCHAR -> duckdb_string_t) built lazily per chunk from the materialized
 * planes. Date/time/hugeint/decimal helpers are pure C (no engine round
 * trip), matching DuckDB's duckdb_from_date/duckdb_hugeint_to_double
 * family.
 *
 * Build: duckdb_tpu_torch.capi.library() compiles this file with the host
 * compiler at first use into build/torch_kernels/libduckdb_tpu_torch_capi.so.
 * The library works both dlopen'd inside a Python process that imported
 * the port (it attaches to the running interpreter via PyGILState; no
 * -lpython needed) and in a C program linked against libpython (it then
 * initializes Python itself).
 */

#include "duckdb_tpu_torch.h"

#include <Python.h>

#include <cmath>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <utility>
#include <vector>

namespace {

std::once_flag g_py_init;

void ensure_python() {
  std::call_once(g_py_init, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      PyEval_SaveThread();
    }
  });
}

struct GIL {
  PyGILState_STATE st;
  GIL() { st = PyGILState_Ensure(); }
  ~GIL() { PyGILState_Release(st); }
};

PyObject *bridge() {
  static PyObject *mod = nullptr;
  if (!mod) {
    mod = PyImport_ImportModule("duckdb_tpu_torch.capi.bridge");
    if (!mod) {
      PyErr_Print();
    }
  }
  return mod;
}

std::string py_err() {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  std::string msg = "unknown error";
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      msg = PyUnicode_AsUTF8(s);
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return msg;
}

struct Database {
  std::string path;
  std::vector<std::pair<std::string, std::string>> settings;  // open_ext
};

struct ConnectionImpl {
  PyObject *con = nullptr;
  ~ConnectionImpl() {
    if (con) {
      GIL g;
      PyObject *b = bridge();
      PyObject *r = b ? PyObject_CallMethod(b, "disconnect", "O", con) : nullptr;
      if (!r) PyErr_Print();
      Py_XDECREF(r);
      Py_DECREF(con);
    }
  }
};

struct Col {
  std::string name;
  duckdb_type type = DUCKDB_TYPE_INVALID;
  char cls = 's';  // 'i' | 'f' | 's'
  std::vector<uint8_t> nulls;
  std::vector<int64_t> ints;
  std::vector<double> dbls;
  std::vector<std::string> strs;
  uint8_t width = 0, scale = 0;  // a DECIMAL's own
};

struct ChunkImpl;

struct ResultImpl {
  std::vector<Col> cols;
  idx_t rows = 0;
  std::string error;
  bool ok = true;
  idx_t fetch_cursor = 0;  // duckdb_fetch_chunk position
  std::vector<ChunkImpl *> owned_chunks;
  ~ResultImpl();
};

/* ---- pure-C date/time math (days-from-civil; Howard Hinnant's
 * algorithm, public domain — DuckDB uses the same arithmetic in
 * src/common/types/date.cpp) --------------------------------------- */

int32_t civil_to_days(int y, unsigned m, unsigned d) {
  y -= m <= 2;
  const int era = (y >= 0 ? y : y - 399) / 400;
  const unsigned yoe = (unsigned)(y - era * 400);
  const unsigned doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + (int)doe - 719468;
}

void days_to_civil(int32_t z, int *y, unsigned *m, unsigned *d) {
  z += 719468;
  const int era = (z >= 0 ? z : z - 146096) / 146097;
  const unsigned doe = (unsigned)(z - era * 146097);
  const unsigned yoe =
      (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  const int yy = (int)yoe + era * 400;
  const unsigned doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  const unsigned mp = (5 * doy + 2) / 153;
  *d = doy - (153 * mp + 2) / 5 + 1;
  *m = mp + (mp < 10 ? 3 : -9);
  *y = yy + (*m <= 2);
}

/* ---- string cell parsers (bridge renders dates/decimals as the
 * engine's canonical text; accessors parse back to C structs) ------ */

bool parse_date_str(const char *s, int32_t *out_days) {
  int y;
  unsigned m, d;
  if (sscanf(s, "%d-%u-%u", &y, &m, &d) != 3) return false;
  *out_days = civil_to_days(y, m, d);
  return true;
}

bool parse_time_str(const char *s, int64_t *out_micros) {
  int h, mi;
  double sec = 0;
  if (sscanf(s, "%d:%d:%lf", &h, &mi, &sec) < 2) return false;
  *out_micros = ((int64_t)h * 3600 + (int64_t)mi * 60) * 1000000 +
                (int64_t)llround(sec * 1e6);
  return true;
}

bool parse_timestamp_str(const char *s, int64_t *out_micros) {
  int32_t days = 0;
  if (!parse_date_str(s, &days)) return false;
  const char *sp = strchr(s, ' ');
  if (!sp) sp = strchr(s, 'T');
  int64_t tod = 0;
  if (sp) parse_time_str(sp + 1, &tod);
  *out_micros = (int64_t)days * 86400000000LL + tod;
  return true;
}

duckdb_hugeint hugeint_from_i64(int64_t v) {
  duckdb_hugeint h;
  h.lower = (uint64_t)v;
  h.upper = v < 0 ? -1 : 0;
  return h;
}

void hugeint_mul10_add(duckdb_hugeint *h, int digit) {
  // h = h*10 + digit, unsigned magnitude arithmetic
  uint64_t lo = h->lower;
  uint64_t hi = (uint64_t)h->upper;
  // 128-bit multiply by 10 = (x<<3) + (x<<1)
  uint64_t lo8 = lo << 3, hi8 = (hi << 3) | (lo >> 61);
  uint64_t lo2 = lo << 1, hi2 = (hi << 1) | (lo >> 63);
  uint64_t nlo = lo8 + lo2;
  uint64_t nhi = hi8 + hi2 + (nlo < lo8 ? 1 : 0);
  uint64_t flo = nlo + (uint64_t)digit;
  nhi += (flo < nlo ? 1 : 0);
  h->lower = flo;
  h->upper = (int64_t)nhi;
}

/* a hugeint in full, in decimal */
std::string hugeint_to_string(duckdb_hugeint h) {
  __int128 v = ((__int128)h.upper << 64) | (__int128)h.lower;
  bool neg = v < 0;
  unsigned __int128 u = neg ? (unsigned __int128)0 - (unsigned __int128)v
                            : (unsigned __int128)v;
  std::string digits;
  do {
    digits.push_back((char)('0' + (int)(u % 10)));
    u /= 10;
  } while (u);
  if (neg) digits.push_back('-');
  return std::string(digits.rbegin(), digits.rend());
}

void hugeint_negate(duckdb_hugeint *h) {
  h->lower = ~h->lower;
  h->upper = ~h->upper;
  h->lower += 1;
  if (h->lower == 0) h->upper += 1;
}

/* parse a decimal-rendered string ("[-]digits[.digits]") into a scaled
 * hugeint + the scale it carried */
bool parse_decimal_str(const char *s, duckdb_hugeint *out, uint8_t *scale,
                       uint8_t *width) {
  duckdb_hugeint acc = {0, 0};
  bool neg = false;
  uint8_t sc = 0, w = 0;
  bool frac = false;
  for (const char *p = s; *p; p++) {
    if (*p == '-' && p == s) {
      neg = true;
    } else if (*p == '.') {
      frac = true;
    } else if (*p >= '0' && *p <= '9') {
      hugeint_mul10_add(&acc, *p - '0');
      w++;
      if (frac) sc++;
    } else {
      return false;
    }
  }
  if (neg) hugeint_negate(&acc);
  *out = acc;
  *scale = sc;
  *width = w ? w : 1;
  return true;
}

bool parse_interval_str(const char *s, duckdb_interval *out) {
  // engine renders intervals as e.g. "1 year 2 months 3 days 04:05:06"
  duckdb_interval iv = {0, 0, 0};
  const char *p = s;
  while (*p) {
    while (*p == ' ') p++;
    if (strchr(p, ':') &&
        (strchr(p, ':') < strchr(p, ' ') || !strchr(p, ' '))) {
      int64_t tod = 0;
      bool tneg = (*p == '-');
      if (parse_time_str(tneg ? p + 1 : p, &tod))
        iv.micros += tneg ? -tod : tod;
      break;
    }
    char unit[32];
    long long n;
    int consumed = 0;
    if (sscanf(p, "%lld %31s%n", &n, unit, &consumed) < 2) break;
    if (!strncmp(unit, "year", 4)) iv.months += (int32_t)(n * 12);
    else if (!strncmp(unit, "mon", 3)) iv.months += (int32_t)n;
    else if (!strncmp(unit, "day", 3)) iv.days += (int32_t)n;
    else if (!strncmp(unit, "hour", 4)) iv.micros += n * 3600000000LL;
    else if (!strncmp(unit, "min", 3)) iv.micros += n * 60000000LL;
    else if (!strncmp(unit, "sec", 3)) iv.micros += n * 1000000LL;
    else if (!strncmp(unit, "milli", 5)) iv.micros += n * 1000LL;
    else if (!strncmp(unit, "micro", 5)) iv.micros += n;
    p += consumed;
  }
  *out = iv;
  return true;
}

ResultImpl *materialize(PyObject *tuple) {
  auto *r = new ResultImpl();
  PyObject *names = PyTuple_GetItem(tuple, 0);
  PyObject *tids = PyTuple_GetItem(tuple, 1);
  PyObject *classes = PyTuple_GetItem(tuple, 2);
  PyObject *cols = PyTuple_GetItem(tuple, 3);
  Py_ssize_t nc = PyList_Size(names);
  for (Py_ssize_t c = 0; c < nc; c++) {
    Col col;
    col.name = PyUnicode_AsUTF8(PyList_GetItem(names, c));
    col.type = (duckdb_type)PyLong_AsLong(PyList_GetItem(tids, c));
    col.cls = PyUnicode_AsUTF8(PyList_GetItem(classes, c))[0];
    if (PyTuple_Size(tuple) > 4) {  // (width, scale) of each column
      PyObject *ws = PyList_GetItem(PyTuple_GetItem(tuple, 4), c);
      col.width = (uint8_t)PyLong_AsLong(PyTuple_GetItem(ws, 0));
      col.scale = (uint8_t)PyLong_AsLong(PyTuple_GetItem(ws, 1));
    }
    PyObject *cells = PyList_GetItem(cols, c);
    Py_ssize_t nr = PyList_Size(cells);
    col.nulls.resize(nr);
    for (Py_ssize_t i = 0; i < nr; i++) {
      PyObject *cell = PyList_GetItem(cells, i);
      col.nulls[i] = PyObject_IsTrue(PyTuple_GetItem(cell, 0)) ? 1 : 0;
      PyObject *v = PyTuple_GetItem(cell, 1);
      if (col.cls == 'i') {
        col.ints.push_back(PyLong_AsLongLong(v));
      } else if (col.cls == 'f') {
        col.dbls.push_back(PyFloat_AsDouble(v));
      } else {
        col.strs.push_back(PyUnicode_AsUTF8(v));
      }
    }
    r->rows = (idx_t)nr;
    r->cols.push_back(std::move(col));
  }
  return r;
}

duckdb_state run_sql_object(PyObject *callable_result, duckdb_result *out) {
  if (!callable_result) {
    auto *r = new ResultImpl();
    r->ok = false;
    r->error = py_err();
    if (out) out->internal_data = r;
    return DuckDBError;
  }
  if (out) {
    out->internal_data = materialize(callable_result);
  }
  Py_DECREF(callable_result);
  return DuckDBSuccess;
}

ResultImpl *impl(duckdb_result *r) {
  return r ? (ResultImpl *)r->internal_data : nullptr;
}

struct PreparedImpl {
  PyObject *stmt = nullptr;
  std::vector<PyObject *> params;  // owned refs, index 0-based
  std::string error;
  ~PreparedImpl() {
    GIL g;
    for (auto *p : params) Py_XDECREF(p);
    Py_XDECREF(stmt);
  }
  void set(idx_t idx, PyObject *v /*stolen*/) {
    if (params.size() < idx) params.resize(idx, nullptr);
    Py_XDECREF(params[idx - 1]);
    params[idx - 1] = v;
  }
};

struct AppenderImpl {
  PyObject *app = nullptr;
  std::vector<PyObject *> row;
  std::string error;
  ~AppenderImpl() {
    GIL g;
    for (auto *p : row) Py_XDECREF(p);
    Py_XDECREF(app);
  }
};

/* logical types: engine-independent descriptors */
struct LT {
  duckdb_type id = DUCKDB_TYPE_INVALID;
  uint8_t width = 0, scale = 0;
  idx_t array_size = 0;
  std::vector<LT *> children;  // owned
  std::vector<std::string> names;
  ~LT() {
    for (auto *c : children) delete c;
  }
};

duckdb_logical_type wrap_lt(LT *t) {
  return (duckdb_logical_type) new _duckdb_logical_type{t};
}
LT *lt(duckdb_logical_type t) { return t ? (LT *)t->internal : nullptr; }

LT *clone_lt(const LT *t) {
  auto *n = new LT();
  n->id = t->id;
  n->width = t->width;
  n->scale = t->scale;
  n->array_size = t->array_size;
  n->names = t->names;
  for (auto *c : t->children) n->children.push_back(clone_lt(c));
  return n;
}

/* values: tagged scalar container */
struct Val {
  duckdb_type id = DUCKDB_TYPE_INVALID;
  bool is_null = false;
  int64_t i = 0;
  uint64_t u = 0;
  double d = 0;
  std::string s;
  duckdb_hugeint h = {0, 0};
  duckdb_interval iv = {0, 0, 0};
};

Val *val(duckdb_value v) { return v ? (Val *)v->internal : nullptr; }

duckdb_value wrap_val(Val *v) {
  return (duckdb_value) new _duckdb_value{v};
}

duckdb_value make_val(duckdb_type id) {
  auto *v = new Val();
  v->id = id;
  return wrap_val(v);
}

/* chunks: 2048-row windows with lazily-built width-faithful planes */
struct VecBuf {
  std::vector<uint8_t> data;      // typed plane bytes
  std::vector<uint64_t> validity; // 64-row words
  LT type;
  bool built = false;
};

// vector handles alive (a test hook: duckdb_tpu_torch_live_vectors)
static long live_vectors = 0;

struct ChunkImpl {
  ResultImpl *r = nullptr;  // non-owning; chunk must not outlive result
  idx_t offset = 0, size = 0;
  std::vector<VecBuf> vecs;
  bool owned_by_result = false;
  // one handle per column, made at its first get_vector and freed with
  // the chunk, as DuckDB's chunk owns its vectors
  std::vector<_duckdb_vector *> handles;
  ~ChunkImpl() {
    for (auto *h : handles) {
      if (!h) continue;
      delete (std::pair<ChunkImpl *, idx_t> *)h->internal;
      delete h;
      live_vectors--;
    }
  }
};

ResultImpl::~ResultImpl() {
  for (auto *c : owned_chunks) delete c;
}

LT col_logical_type(const Col &c, const ResultImpl *r, idx_t /*ci*/) {
  LT t;
  t.id = c.type;
  if (c.type == DUCKDB_TYPE_DECIMAL && c.width) {
    t.width = c.width;  // the column's own type
    t.scale = c.scale;
  } else if (c.type == DUCKDB_TYPE_DECIMAL) {
    // derive width/scale from the rendered cells (bridge stringifies
    // decimals with the engine's canonical scale)
    uint8_t w = 18, sc = 0;
    for (idx_t i = 0; i < r->rows; i++) {
      if (!c.nulls[i] && i < c.strs.size()) {
        duckdb_hugeint hv;
        uint8_t cw;
        if (parse_decimal_str(c.strs[i].c_str(), &hv, &sc, &cw)) w = 18;
        break;
      }
    }
    t.width = w;
    t.scale = sc;
  }
  return t;
}

template <typename T>
void put(std::vector<uint8_t> &buf, idx_t i, T v) {
  memcpy(buf.data() + i * sizeof(T), &v, sizeof(T));
}

void build_vec(ChunkImpl *ch, idx_t ci) {
  VecBuf &vb = ch->vecs[ci];
  if (vb.built) return;
  const Col &c = ch->r->cols[ci];
  vb.type = col_logical_type(c, ch->r, ci);
  idx_t n = ch->size;
  vb.validity.assign((n + 63) / 64, ~0ULL);
  for (idx_t i = 0; i < n; i++) {
    if (c.nulls[ch->offset + i]) {
      vb.validity[i / 64] &= ~(1ULL << (i % 64));
    }
  }
  auto cell_str = [&](idx_t i) -> const std::string & {
    return c.strs[ch->offset + i];
  };
  switch (c.type) {
    case DUCKDB_TYPE_BOOLEAN: {
      vb.data.resize(n);
      for (idx_t i = 0; i < n; i++)
        vb.data[i] = c.ints.empty() ? 0 : (c.ints[ch->offset + i] != 0);
      break;
    }
    case DUCKDB_TYPE_TINYINT: {
      vb.data.resize(n * 1);
      for (idx_t i = 0; i < n; i++)
        put<int8_t>(vb.data, i, (int8_t)c.ints[ch->offset + i]);
      break;
    }
    case DUCKDB_TYPE_SMALLINT: {
      vb.data.resize(n * 2);
      for (idx_t i = 0; i < n; i++)
        put<int16_t>(vb.data, i, (int16_t)c.ints[ch->offset + i]);
      break;
    }
    case DUCKDB_TYPE_INTEGER: {
      vb.data.resize(n * 4);
      for (idx_t i = 0; i < n; i++)
        put<int32_t>(vb.data, i, (int32_t)c.ints[ch->offset + i]);
      break;
    }
    case DUCKDB_TYPE_FLOAT: {
      vb.data.resize(n * 4);
      for (idx_t i = 0; i < n; i++)
        put<float>(vb.data, i, (float)c.dbls[ch->offset + i]);
      break;
    }
    case DUCKDB_TYPE_DOUBLE: {
      vb.data.resize(n * 8);
      for (idx_t i = 0; i < n; i++)
        put<double>(vb.data, i, c.dbls[ch->offset + i]);
      break;
    }
    case DUCKDB_TYPE_DATE: {
      vb.data.resize(n * 4);
      for (idx_t i = 0; i < n; i++) {
        int32_t days = 0;
        if (!c.nulls[ch->offset + i] && c.cls == 's')
          parse_date_str(cell_str(i).c_str(), &days);
        else if (c.cls == 'i')
          days = (int32_t)c.ints[ch->offset + i];
        put<int32_t>(vb.data, i, days);
      }
      break;
    }
    case DUCKDB_TYPE_TIME: {
      vb.data.resize(n * 8);
      for (idx_t i = 0; i < n; i++) {
        int64_t us = 0;
        if (!c.nulls[ch->offset + i] && c.cls == 's')
          parse_time_str(cell_str(i).c_str(), &us);
        else if (c.cls == 'i')
          us = c.ints[ch->offset + i];
        put<int64_t>(vb.data, i, us);
      }
      break;
    }
    case DUCKDB_TYPE_TIMESTAMP:
    case DUCKDB_TYPE_TIMESTAMP_TZ: {
      vb.data.resize(n * 8);
      for (idx_t i = 0; i < n; i++) {
        int64_t us = 0;
        if (!c.nulls[ch->offset + i] && c.cls == 's')
          parse_timestamp_str(cell_str(i).c_str(), &us);
        else if (c.cls == 'i')
          us = c.ints[ch->offset + i];
        put<int64_t>(vb.data, i, us);
      }
      break;
    }
    case DUCKDB_TYPE_DECIMAL: {
      // scaled int64 plane (internal type BIGINT)
      vb.data.resize(n * 8);
      for (idx_t i = 0; i < n; i++) {
        int64_t scaled = 0;
        if (!c.nulls[ch->offset + i] && c.cls == 's') {
          duckdb_hugeint hv;
          uint8_t sc, w;
          if (parse_decimal_str(cell_str(i).c_str(), &hv, &sc, &w))
            scaled = (int64_t)hv.lower;
        } else if (c.cls == 'i') {
          scaled = c.ints[ch->offset + i];
        } else if (c.cls == 'f') {
          scaled = (int64_t)c.dbls[ch->offset + i];
        }
        put<int64_t>(vb.data, i, scaled);
      }
      break;
    }
    case DUCKDB_TYPE_BIGINT:
    case DUCKDB_TYPE_HUGEINT:
    default: {
      if (c.cls == 'i') {
        vb.data.resize(n * 8);
        for (idx_t i = 0; i < n; i++)
          put<int64_t>(vb.data, i, c.ints[ch->offset + i]);
      } else if (c.cls == 'f') {
        vb.data.resize(n * 8);
        for (idx_t i = 0; i < n; i++)
          put<double>(vb.data, i, c.dbls[ch->offset + i]);
      } else {
        // string cells -> DuckDB's string_t layout pointing into the
        // result-owned std::string storage
        vb.data.resize(n * sizeof(duckdb_string_t));
        for (idx_t i = 0; i < n; i++) {
          duckdb_string_t sv;
          memset(&sv, 0, sizeof sv);
          const std::string &s = cell_str(i);
          uint32_t len = (uint32_t)s.size();
          if (len <= 12) {
            sv.value.inlined.length = len;
            memcpy(sv.value.inlined.inlined, s.data(), len);
          } else {
            sv.value.pointer.length = len;
            memcpy(sv.value.pointer.prefix, s.data(), 4);
            sv.value.pointer.ptr = s.c_str();
          }
          memcpy(vb.data.data() + i * sizeof(duckdb_string_t), &sv,
                 sizeof sv);
        }
      }
      break;
    }
  }
  vb.built = true;
}

const char *known_flags[][2] = {
    {"access_mode", "Access mode of the database (AUTOMATIC/READ_ONLY/"
                    "READ_WRITE)"},
    {"device", "Device of the database's columns: cuda (the default) or cpu"},
    {"threads", "Host threads (stored; no effect in the port)"},
    {"memory_limit", "Device memory budget for resident columns (0 = none)"},
    {"max_memory", "Maximum engine memory (alias of memory_limit)"},
    {"temp_directory", "Spill directory for out-of-core operators"},
    {"default_order", "Default sort order (ASC/DESC)"},
    {"default_null_order", "NULL ordering (NULLS_FIRST/NULLS_LAST)"},
    {"enable_object_cache", "Cache compiled query programs"},
    {"preserve_insertion_order", "Preserve insertion order in results"},
    {"checkpoint_threshold", "WAL size triggering automatic checkpoint"},
    {"num_shards", "Shards (1 = one device, the default; 0 = auto)"},
    {"auto_shard_rows", "Minimum rows before auto-sharding engages"},
    {"exchange_join_threshold", "Dense-table size above which sharded joins "
                                "repartition both sides"},
    {"pallas_grouped_sum", "Grouped-sum kernel for int64 sums (auto/on/off)"},
    {"join_order", "Join-order algorithm (dp/greedy)"},
    {"timezone", "Session time zone"},
};

struct ConfigImpl {
  std::vector<std::pair<std::string, std::string>> entries;
};

}  // namespace

extern "C" {

/* -- open / close ---------------------------------------------------------- */

duckdb_state duckdb_open(const char *path, duckdb_database *out_database) {
  ensure_python();
  auto *db = new Database();
  db->path = path ? path : ":memory:";
  *out_database = (duckdb_database) new _duckdb_database{db};
  return DuckDBSuccess;
}

duckdb_state duckdb_open_ext(const char *path, duckdb_database *out_database,
                             duckdb_config config, char **out_error) {
  duckdb_state st = duckdb_open(path, out_database);
  if (st != DuckDBSuccess) {
    if (out_error) *out_error = strdup("open failed");
    return st;
  }
  if (config && config->internal) {
    auto *db = (Database *)(*out_database)->internal;
    db->settings = ((ConfigImpl *)config->internal)->entries;
    // the entries are checked here, as DuckDB resolves its config at open
    // (a bad option fails the open), and SET on each connection
    GIL g;
    PyObject *b = bridge();
    PyObject *pairs = PyList_New((Py_ssize_t)db->settings.size());
    for (size_t i = 0; i < db->settings.size(); i++) {
      PyList_SetItem(pairs, (Py_ssize_t)i,
                     Py_BuildValue("(ss)", db->settings[i].first.c_str(),
                                   db->settings[i].second.c_str()));
    }
    PyObject *r = b ? PyObject_CallMethod(b, "check_config", "O", pairs) : nullptr;
    Py_DECREF(pairs);
    if (!r) {
      std::string msg = b ? py_err() : "the bridge module did not import";
      if (out_error) *out_error = strdup(msg.c_str());
      duckdb_close(out_database);
      return DuckDBError;
    }
    Py_DECREF(r);
  }
  return DuckDBSuccess;
}

void duckdb_close(duckdb_database *database) {
  if (database && *database) {
    delete (Database *)(*database)->internal;
    delete *database;
    *database = nullptr;
  }
}

const char *duckdb_library_version(void) { return "duckdb_tpu_torch 0.1.0"; }

void duckdb_interrupt(duckdb_connection connection) {
  (void)connection;  // queries execute synchronously under the GIL
}

duckdb_state duckdb_connect(duckdb_database database,
                            duckdb_connection *out_connection) {
  ensure_python();
  GIL g;
  auto *db = (Database *)database->internal;
  PyObject *b = bridge();
  if (!b) return DuckDBError;
  // the config entries: "device" picks the connection's device, the rest
  // are SET on it (bridge.connect)
  PyObject *pairs = PyList_New((Py_ssize_t)db->settings.size());
  for (size_t i = 0; i < db->settings.size(); i++) {
    PyList_SetItem(pairs, (Py_ssize_t)i,
                   Py_BuildValue("(ss)", db->settings[i].first.c_str(),
                                 db->settings[i].second.c_str()));
  }
  PyObject *con = PyObject_CallMethod(b, "connect", "sO", db->path.c_str(), pairs);
  Py_DECREF(pairs);
  if (!con) {
    PyErr_Print();
    return DuckDBError;
  }
  auto *ci = new ConnectionImpl();
  ci->con = con;
  *out_connection = (duckdb_connection) new _duckdb_connection{ci};
  return DuckDBSuccess;
}

void duckdb_disconnect(duckdb_connection *connection) {
  if (connection && *connection) {
    delete (ConnectionImpl *)(*connection)->internal;
    delete *connection;
    *connection = nullptr;
  }
}

/* -- configuration --------------------------------------------------------- */

duckdb_state duckdb_create_config(duckdb_config *out_config) {
  *out_config = (duckdb_config) new _duckdb_config{new ConfigImpl()};
  return DuckDBSuccess;
}

size_t duckdb_config_count(void) {
  return sizeof(known_flags) / sizeof(known_flags[0]);
}

duckdb_state duckdb_get_config_flag(size_t index, const char **out_name,
                                    const char **out_description) {
  if (index >= duckdb_config_count()) return DuckDBError;
  if (out_name) *out_name = known_flags[index][0];
  if (out_description) *out_description = known_flags[index][1];
  return DuckDBSuccess;
}

duckdb_state duckdb_set_config(duckdb_config config, const char *name,
                               const char *option) {
  if (!config || !config->internal || !name || !option) return DuckDBError;
  ((ConfigImpl *)config->internal)->entries.emplace_back(name, option);
  return DuckDBSuccess;
}

void duckdb_destroy_config(duckdb_config *config) {
  if (config && *config) {
    delete (ConfigImpl *)(*config)->internal;
    delete *config;
    *config = nullptr;
  }
}

/* -- query ----------------------------------------------------------------- */

duckdb_state duckdb_query(duckdb_connection connection, const char *query,
                          duckdb_result *out_result) {
  GIL g;
  auto *ci = (ConnectionImpl *)connection->internal;
  PyObject *res = PyObject_CallMethod(bridge(), "query", "Os", ci->con, query);
  return run_sql_object(res, out_result);
}

void duckdb_destroy_result(duckdb_result *result) {
  if (result && result->internal_data) {
    delete impl(result);
    result->internal_data = nullptr;
  }
}

const char *duckdb_result_error(duckdb_result *result) {
  auto *r = impl(result);
  return (r && !r->ok) ? r->error.c_str() : nullptr;
}

idx_t duckdb_column_count(duckdb_result *result) {
  auto *r = impl(result);
  return r ? (idx_t)r->cols.size() : 0;
}

idx_t duckdb_row_count(duckdb_result *result) {
  auto *r = impl(result);
  return r ? r->rows : 0;
}

idx_t duckdb_rows_changed(duckdb_result *result) {
  // DML statements surface a single-row "Count" BIGINT column
  // (api/connection.py _count_result; DuckDB: MaterializedQueryResult
  // row count for changed rows)
  auto *r = impl(result);
  if (r && r->ok && r->cols.size() == 1 && r->rows == 1 &&
      r->cols[0].cls == 'i' && r->cols[0].name == "Count") {
    return (idx_t)r->cols[0].ints[0];
  }
  return 0;
}

const char *duckdb_column_name(duckdb_result *result, idx_t col) {
  auto *r = impl(result);
  return (r && col < r->cols.size()) ? r->cols[col].name.c_str() : nullptr;
}

duckdb_type duckdb_column_type(duckdb_result *result, idx_t col) {
  auto *r = impl(result);
  return (r && col < r->cols.size()) ? r->cols[col].type
                                     : DUCKDB_TYPE_INVALID;
}

duckdb_logical_type duckdb_column_logical_type(duckdb_result *result,
                                               idx_t col) {
  auto *r = impl(result);
  if (!r || col >= r->cols.size()) return nullptr;
  return wrap_lt(clone_lt(&(const LT &)col_logical_type(
      r->cols[col], r, col)));
}

/* -- typed value accessors ------------------------------------------------- */

bool duckdb_value_is_null(duckdb_result *result, idx_t col, idx_t row) {
  auto *r = impl(result);
  if (!r || col >= r->cols.size() || row >= r->rows) return true;
  return r->cols[col].nulls[row] != 0;
}

bool duckdb_value_boolean(duckdb_result *result, idx_t col, idx_t row) {
  return duckdb_value_int64(result, col, row) != 0;
}

int64_t duckdb_value_int64(duckdb_result *result, idx_t col, idx_t row) {
  auto *r = impl(result);
  if (!r || col >= r->cols.size() || row >= r->rows) return 0;
  const Col &c = r->cols[col];
  if (c.nulls[row]) return 0;
  if (c.cls == 'i') return c.ints[row];
  if (c.cls == 'f') return (int64_t)c.dbls[row];
  return atoll(c.strs[row].c_str());
}

int8_t duckdb_value_int8(duckdb_result *r, idx_t c, idx_t row) {
  return (int8_t)duckdb_value_int64(r, c, row);
}
int16_t duckdb_value_int16(duckdb_result *r, idx_t c, idx_t row) {
  return (int16_t)duckdb_value_int64(r, c, row);
}
int32_t duckdb_value_int32(duckdb_result *r, idx_t c, idx_t row) {
  return (int32_t)duckdb_value_int64(r, c, row);
}
uint8_t duckdb_value_uint8(duckdb_result *r, idx_t c, idx_t row) {
  return (uint8_t)duckdb_value_int64(r, c, row);
}
uint16_t duckdb_value_uint16(duckdb_result *r, idx_t c, idx_t row) {
  return (uint16_t)duckdb_value_int64(r, c, row);
}
uint32_t duckdb_value_uint32(duckdb_result *r, idx_t c, idx_t row) {
  return (uint32_t)duckdb_value_int64(r, c, row);
}
uint64_t duckdb_value_uint64(duckdb_result *r, idx_t c, idx_t row) {
  return (uint64_t)duckdb_value_int64(r, c, row);
}
float duckdb_value_float(duckdb_result *r, idx_t c, idx_t row) {
  return (float)duckdb_value_double(r, c, row);
}

double duckdb_value_double(duckdb_result *result, idx_t col, idx_t row) {
  auto *r = impl(result);
  if (!r || col >= r->cols.size() || row >= r->rows) return 0.0;
  const Col &c = r->cols[col];
  if (c.nulls[row]) return 0.0;
  if (c.cls == 'f') return c.dbls[row];
  if (c.cls == 'i') return (double)c.ints[row];
  return atof(c.strs[row].c_str());
}

duckdb_hugeint duckdb_value_hugeint(duckdb_result *result, idx_t col,
                                    idx_t row) {
  duckdb_hugeint out = {0, 0};
  auto *r = impl(result);
  if (!r || col >= r->cols.size() || row >= r->rows) return out;
  const Col &c = r->cols[col];
  if (c.nulls[row]) return out;
  if (c.cls == 'i') return hugeint_from_i64(c.ints[row]);
  if (c.cls == 'f') return hugeint_from_i64((int64_t)c.dbls[row]);
  uint8_t sc, w;
  parse_decimal_str(c.strs[row].c_str(), &out, &sc, &w);
  return out;
}

duckdb_decimal duckdb_value_decimal(duckdb_result *result, idx_t col,
                                    idx_t row) {
  duckdb_decimal out = {18, 0, {0, 0}};
  auto *r = impl(result);
  if (!r || col >= r->cols.size() || row >= r->rows) return out;
  const Col &c = r->cols[col];
  if (c.nulls[row]) return out;
  if (c.cls == 's') {
    parse_decimal_str(c.strs[row].c_str(), &out.value, &out.scale,
                      &out.width);
    out.width = out.width > 18 ? out.width : 18;
  } else if (c.cls == 'i') {
    out.value = hugeint_from_i64(c.ints[row]);
  } else {
    out.value = hugeint_from_i64((int64_t)llround(c.dbls[row]));
  }
  return out;
}

duckdb_date duckdb_value_date(duckdb_result *result, idx_t col, idx_t row) {
  duckdb_date out = {0};
  auto *r = impl(result);
  if (!r || col >= r->cols.size() || row >= r->rows) return out;
  const Col &c = r->cols[col];
  if (c.nulls[row]) return out;
  if (c.cls == 's') parse_date_str(c.strs[row].c_str(), &out.days);
  else if (c.cls == 'i') out.days = (int32_t)c.ints[row];
  return out;
}

duckdb_time duckdb_value_time(duckdb_result *result, idx_t col, idx_t row) {
  duckdb_time out = {0};
  auto *r = impl(result);
  if (!r || col >= r->cols.size() || row >= r->rows) return out;
  const Col &c = r->cols[col];
  if (c.nulls[row]) return out;
  if (c.cls == 's') parse_time_str(c.strs[row].c_str(), &out.micros);
  else if (c.cls == 'i') out.micros = c.ints[row];
  return out;
}

duckdb_timestamp duckdb_value_timestamp(duckdb_result *result, idx_t col,
                                        idx_t row) {
  duckdb_timestamp out = {0};
  auto *r = impl(result);
  if (!r || col >= r->cols.size() || row >= r->rows) return out;
  const Col &c = r->cols[col];
  if (c.nulls[row]) return out;
  if (c.cls == 's') parse_timestamp_str(c.strs[row].c_str(), &out.micros);
  else if (c.cls == 'i') out.micros = c.ints[row];
  return out;
}

duckdb_interval duckdb_value_interval(duckdb_result *result, idx_t col,
                                      idx_t row) {
  duckdb_interval out = {0, 0, 0};
  auto *r = impl(result);
  if (!r || col >= r->cols.size() || row >= r->rows) return out;
  const Col &c = r->cols[col];
  if (c.nulls[row]) return out;
  if (c.cls == 's') parse_interval_str(c.strs[row].c_str(), &out);
  return out;
}

char *duckdb_value_varchar(duckdb_result *result, idx_t col, idx_t row) {
  auto *r = impl(result);
  if (!r || col >= r->cols.size() || row >= r->rows) return nullptr;
  const Col &c = r->cols[col];
  if (c.nulls[row]) return nullptr;
  std::string s;
  if (c.cls == 's') {
    s = c.strs[row];
  } else if (c.cls == 'i') {
    s = std::to_string(c.ints[row]);
  } else {
    char buf[32];
    snprintf(buf, sizeof buf, "%g", c.dbls[row]);
    s = buf;
  }
  char *out = (char *)malloc(s.size() + 1);
  memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

duckdb_string duckdb_value_string(duckdb_result *result, idx_t col,
                                  idx_t row) {
  duckdb_string out = {nullptr, 0};
  out.data = duckdb_value_varchar(result, col, row);
  out.size = out.data ? strlen(out.data) : 0;
  return out;
}

duckdb_blob duckdb_value_blob(duckdb_result *result, idx_t col, idx_t row) {
  duckdb_blob out = {nullptr, 0};
  char *s = duckdb_value_varchar(result, col, row);
  if (s) {
    out.data = s;
    out.size = strlen(s);
  }
  return out;
}

void duckdb_free(void *ptr) { free(ptr); }

idx_t duckdb_vector_size(void) { return DUCKDB_TPU_TORCH_VECTOR_SIZE; }

/* -- date / time / hugeint / decimal helpers ------------------------------- */

duckdb_date_struct duckdb_from_date(duckdb_date date) {
  duckdb_date_struct out;
  int y;
  unsigned m, d;
  days_to_civil(date.days, &y, &m, &d);
  out.year = y;
  out.month = (int8_t)m;
  out.day = (int8_t)d;
  return out;
}

duckdb_date duckdb_to_date(duckdb_date_struct date) {
  duckdb_date out;
  out.days = civil_to_days(date.year, (unsigned)date.month,
                           (unsigned)date.day);
  return out;
}

bool duckdb_is_finite_date(duckdb_date date) {
  return date.days != INT32_MAX && date.days != -INT32_MAX;
}

duckdb_time_struct duckdb_from_time(duckdb_time time) {
  duckdb_time_struct out;
  int64_t us = time.micros;
  out.hour = (int8_t)(us / 3600000000LL);
  us %= 3600000000LL;
  out.min = (int8_t)(us / 60000000LL);
  us %= 60000000LL;
  out.sec = (int8_t)(us / 1000000LL);
  out.micros = (int32_t)(us % 1000000LL);
  return out;
}

duckdb_time duckdb_to_time(duckdb_time_struct time) {
  duckdb_time out;
  out.micros = ((int64_t)time.hour * 3600 + (int64_t)time.min * 60 +
                time.sec) * 1000000LL + time.micros;
  return out;
}

duckdb_timestamp_struct duckdb_from_timestamp(duckdb_timestamp ts) {
  duckdb_timestamp_struct out;
  int64_t days = ts.micros / 86400000000LL;
  int64_t tod = ts.micros % 86400000000LL;
  if (tod < 0) {
    days -= 1;
    tod += 86400000000LL;
  }
  duckdb_date d = {(int32_t)days};
  duckdb_time t = {tod};
  out.date = duckdb_from_date(d);
  out.time = duckdb_from_time(t);
  return out;
}

duckdb_timestamp duckdb_to_timestamp(duckdb_timestamp_struct ts) {
  duckdb_timestamp out;
  out.micros = (int64_t)duckdb_to_date(ts.date).days * 86400000000LL +
               duckdb_to_time(ts.time).micros;
  return out;
}

bool duckdb_is_finite_timestamp(duckdb_timestamp ts) {
  return ts.micros != INT64_MAX && ts.micros != -INT64_MAX;
}

double duckdb_hugeint_to_double(duckdb_hugeint val) {
  return (double)val.upper * 18446744073709551616.0 + (double)val.lower;
}

duckdb_hugeint duckdb_double_to_hugeint(double val) {
  duckdb_hugeint out = {0, 0};
  if (!std::isfinite(val)) return out;
  bool neg = val < 0;
  double a = neg ? -val : val;
  out.upper = (int64_t)(a / 18446744073709551616.0);
  out.lower = (uint64_t)(a - (double)out.upper * 18446744073709551616.0);
  if (neg) hugeint_negate(&out);
  return out;
}

double duckdb_decimal_to_double(duckdb_decimal val) {
  double v = duckdb_hugeint_to_double(val.value);
  for (uint8_t i = 0; i < val.scale; i++) v /= 10.0;
  return v;
}

/* -- logical types ---------------------------------------------------------- */

duckdb_logical_type duckdb_create_logical_type(duckdb_type type) {
  auto *t = new LT();
  t->id = type;
  return wrap_lt(t);
}

duckdb_type duckdb_get_type_id(duckdb_logical_type type) {
  return lt(type) ? lt(type)->id : DUCKDB_TYPE_INVALID;
}

void duckdb_destroy_logical_type(duckdb_logical_type *type) {
  if (type && *type) {
    delete lt(*type);
    delete *type;
    *type = nullptr;
  }
}

duckdb_logical_type duckdb_create_decimal_type(uint8_t width, uint8_t scale) {
  auto *t = new LT();
  t->id = DUCKDB_TYPE_DECIMAL;
  t->width = width;
  t->scale = scale;
  return wrap_lt(t);
}

uint8_t duckdb_decimal_width(duckdb_logical_type type) {
  return lt(type) ? lt(type)->width : 0;
}

uint8_t duckdb_decimal_scale(duckdb_logical_type type) {
  return lt(type) ? lt(type)->scale : 0;
}

duckdb_type duckdb_decimal_internal_type(duckdb_logical_type type) {
  LT *t = lt(type);
  if (!t || t->id != DUCKDB_TYPE_DECIMAL) return DUCKDB_TYPE_INVALID;
  if (t->width <= 4) return DUCKDB_TYPE_SMALLINT;
  if (t->width <= 9) return DUCKDB_TYPE_INTEGER;
  if (t->width <= 18) return DUCKDB_TYPE_BIGINT;
  return DUCKDB_TYPE_HUGEINT;
}

duckdb_logical_type duckdb_create_list_type(duckdb_logical_type child) {
  auto *t = new LT();
  t->id = DUCKDB_TYPE_LIST;
  t->children.push_back(lt(child) ? clone_lt(lt(child)) : new LT());
  return wrap_lt(t);
}

duckdb_logical_type duckdb_list_type_child_type(duckdb_logical_type type) {
  LT *t = lt(type);
  if (!t || t->children.empty()) return nullptr;
  return wrap_lt(clone_lt(t->children[0]));
}

duckdb_logical_type duckdb_create_array_type(duckdb_logical_type child,
                                             idx_t array_size) {
  auto *t = new LT();
  t->id = DUCKDB_TYPE_ARRAY;
  t->array_size = array_size;
  t->children.push_back(lt(child) ? clone_lt(lt(child)) : new LT());
  return wrap_lt(t);
}

idx_t duckdb_array_type_array_size(duckdb_logical_type type) {
  return lt(type) ? lt(type)->array_size : 0;
}

duckdb_logical_type duckdb_array_type_child_type(duckdb_logical_type type) {
  return duckdb_list_type_child_type(type);
}

duckdb_logical_type duckdb_create_map_type(duckdb_logical_type key,
                                           duckdb_logical_type value) {
  auto *t = new LT();
  t->id = DUCKDB_TYPE_MAP;
  t->children.push_back(lt(key) ? clone_lt(lt(key)) : new LT());
  t->children.push_back(lt(value) ? clone_lt(lt(value)) : new LT());
  return wrap_lt(t);
}

duckdb_logical_type duckdb_map_type_key_type(duckdb_logical_type type) {
  LT *t = lt(type);
  if (!t || t->children.size() < 2) return nullptr;
  return wrap_lt(clone_lt(t->children[0]));
}

duckdb_logical_type duckdb_map_type_value_type(duckdb_logical_type type) {
  LT *t = lt(type);
  if (!t || t->children.size() < 2) return nullptr;
  return wrap_lt(clone_lt(t->children[1]));
}

duckdb_logical_type duckdb_create_struct_type(duckdb_logical_type *types,
                                              const char **names,
                                              idx_t count) {
  auto *t = new LT();
  t->id = DUCKDB_TYPE_STRUCT;
  for (idx_t i = 0; i < count; i++) {
    t->children.push_back(lt(types[i]) ? clone_lt(lt(types[i])) : new LT());
    t->names.push_back(names[i] ? names[i] : "");
  }
  return wrap_lt(t);
}

idx_t duckdb_struct_type_child_count(duckdb_logical_type type) {
  return lt(type) ? (idx_t)lt(type)->children.size() : 0;
}

char *duckdb_struct_type_child_name(duckdb_logical_type type, idx_t index) {
  LT *t = lt(type);
  if (!t || index >= t->names.size()) return nullptr;
  return strdup(t->names[index].c_str());
}

duckdb_logical_type duckdb_struct_type_child_type(duckdb_logical_type type,
                                                  idx_t index) {
  LT *t = lt(type);
  if (!t || index >= t->children.size()) return nullptr;
  return wrap_lt(clone_lt(t->children[index]));
}

/* -- values ------------------------------------------------------------------ */

duckdb_value duckdb_create_varchar_length(const char *text, idx_t length) {
  duckdb_value v = make_val(DUCKDB_TYPE_VARCHAR);
  val(v)->s.assign(text ? text : "", text ? length : 0);
  return v;
}

duckdb_value duckdb_create_varchar(const char *text) {
  return duckdb_create_varchar_length(text, text ? strlen(text) : 0);
}

#define MAKE_NUM_VALUE(fname, ctype, tid, field, cast)                  \
  duckdb_value fname(ctype input) {                                     \
    duckdb_value v = make_val(tid);                                     \
    val(v)->field = cast input;                                         \
    return v;                                                           \
  }

MAKE_NUM_VALUE(duckdb_create_bool, bool, DUCKDB_TYPE_BOOLEAN, i, (int64_t))
MAKE_NUM_VALUE(duckdb_create_int8, int8_t, DUCKDB_TYPE_TINYINT, i, (int64_t))
MAKE_NUM_VALUE(duckdb_create_int16, int16_t, DUCKDB_TYPE_SMALLINT, i,
               (int64_t))
MAKE_NUM_VALUE(duckdb_create_int32, int32_t, DUCKDB_TYPE_INTEGER, i,
               (int64_t))
MAKE_NUM_VALUE(duckdb_create_int64, int64_t, DUCKDB_TYPE_BIGINT, i, (int64_t))
MAKE_NUM_VALUE(duckdb_create_uint64, uint64_t, DUCKDB_TYPE_UBIGINT, u,
               (uint64_t))
MAKE_NUM_VALUE(duckdb_create_float, float, DUCKDB_TYPE_FLOAT, d, (double))
MAKE_NUM_VALUE(duckdb_create_double, double, DUCKDB_TYPE_DOUBLE, d, (double))

duckdb_value duckdb_create_date(duckdb_date input) {
  duckdb_value v = make_val(DUCKDB_TYPE_DATE);
  val(v)->i = input.days;
  return v;
}

duckdb_value duckdb_create_time(duckdb_time input) {
  duckdb_value v = make_val(DUCKDB_TYPE_TIME);
  val(v)->i = input.micros;
  return v;
}

duckdb_value duckdb_create_timestamp(duckdb_timestamp input) {
  duckdb_value v = make_val(DUCKDB_TYPE_TIMESTAMP);
  val(v)->i = input.micros;
  return v;
}

duckdb_value duckdb_create_interval(duckdb_interval input) {
  duckdb_value v = make_val(DUCKDB_TYPE_INTERVAL);
  val(v)->iv = input;
  return v;
}

duckdb_value duckdb_create_hugeint(duckdb_hugeint input) {
  duckdb_value v = make_val(DUCKDB_TYPE_HUGEINT);
  val(v)->h = input;
  val(v)->i = (int64_t)input.lower;
  return v;
}

duckdb_value duckdb_create_null_value(void) {
  duckdb_value v = make_val(DUCKDB_TYPE_INVALID);
  val(v)->is_null = true;
  return v;
}

bool duckdb_is_null_value(duckdb_value value) {
  return val(value) ? val(value)->is_null : true;
}

bool duckdb_get_bool(duckdb_value v) { return val(v) && val(v)->i != 0; }
int8_t duckdb_get_int8(duckdb_value v) {
  return val(v) ? (int8_t)val(v)->i : 0;
}
int16_t duckdb_get_int16(duckdb_value v) {
  return val(v) ? (int16_t)val(v)->i : 0;
}
int32_t duckdb_get_int32(duckdb_value v) {
  return val(v) ? (int32_t)val(v)->i : 0;
}
int64_t duckdb_get_int64(duckdb_value v) { return val(v) ? val(v)->i : 0; }
uint64_t duckdb_get_uint64(duckdb_value v) {
  return val(v) ? val(v)->u : 0;
}
float duckdb_get_float(duckdb_value v) {
  return val(v) ? (float)val(v)->d : 0.f;
}
double duckdb_get_double(duckdb_value v) { return val(v) ? val(v)->d : 0.0; }

duckdb_date duckdb_get_date(duckdb_value v) {
  duckdb_date d = {val(v) ? (int32_t)val(v)->i : 0};
  return d;
}
duckdb_time duckdb_get_time(duckdb_value v) {
  duckdb_time t = {val(v) ? val(v)->i : 0};
  return t;
}
duckdb_timestamp duckdb_get_timestamp(duckdb_value v) {
  duckdb_timestamp t = {val(v) ? val(v)->i : 0};
  return t;
}
duckdb_interval duckdb_get_interval(duckdb_value v) {
  duckdb_interval iv = {0, 0, 0};
  return val(v) ? val(v)->iv : iv;
}
duckdb_hugeint duckdb_get_hugeint(duckdb_value v) {
  duckdb_hugeint h = {0, 0};
  return val(v) ? val(v)->h : h;
}

char *duckdb_get_varchar(duckdb_value v) {
  if (!val(v)) return nullptr;
  Val *x = val(v);
  std::string s = x->s;
  if (x->id != DUCKDB_TYPE_VARCHAR) {
    if (x->id == DUCKDB_TYPE_DOUBLE || x->id == DUCKDB_TYPE_FLOAT) {
      char buf[32];
      snprintf(buf, sizeof buf, "%g", x->d);
      s = buf;
    } else if (x->id == DUCKDB_TYPE_HUGEINT) {
      s = hugeint_to_string(x->h);
    } else if (x->id == DUCKDB_TYPE_UBIGINT) {
      s = std::to_string(x->u);
    } else {
      s = std::to_string(x->i);
    }
  }
  char *out = (char *)malloc(s.size() + 1);
  memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

duckdb_logical_type duckdb_get_value_type(duckdb_value v) {
  return duckdb_create_logical_type(val(v) ? val(v)->id
                                           : DUCKDB_TYPE_INVALID);
}

void duckdb_destroy_value(duckdb_value *value) {
  if (value && *value) {
    delete val(*value);
    delete *value;
    *value = nullptr;
  }
}

/* -- data chunks + vectors --------------------------------------------------- */

idx_t duckdb_result_chunk_count(duckdb_result result) {
  auto *r = (ResultImpl *)result.internal_data;
  if (!r || !r->ok) return 0;
  return (r->rows + DUCKDB_TPU_TORCH_VECTOR_SIZE - 1) / DUCKDB_TPU_TORCH_VECTOR_SIZE;
}

duckdb_data_chunk duckdb_result_get_chunk(duckdb_result result,
                                          idx_t chunk_index) {
  auto *r = (ResultImpl *)result.internal_data;
  if (!r || !r->ok) return nullptr;
  idx_t off = chunk_index * DUCKDB_TPU_TORCH_VECTOR_SIZE;
  if (off >= r->rows && !(r->rows == 0 && chunk_index == 0)) return nullptr;
  auto *ch = new ChunkImpl();
  ch->r = r;
  ch->offset = off;
  ch->size = r->rows - off < DUCKDB_TPU_TORCH_VECTOR_SIZE ? r->rows - off
                                                    : DUCKDB_TPU_TORCH_VECTOR_SIZE;
  ch->vecs.resize(r->cols.size());
  return (duckdb_data_chunk) new _duckdb_data_chunk{ch};
}

duckdb_data_chunk duckdb_fetch_chunk(duckdb_result result) {
  auto *r = (ResultImpl *)result.internal_data;
  if (!r || !r->ok) return nullptr;
  if (r->fetch_cursor >= duckdb_result_chunk_count(result)) return nullptr;
  return duckdb_result_get_chunk(result, r->fetch_cursor++);
}

void duckdb_destroy_data_chunk(duckdb_data_chunk *chunk) {
  if (chunk && *chunk) {
    delete (ChunkImpl *)(*chunk)->internal;
    delete *chunk;
    *chunk = nullptr;
  }
}

idx_t duckdb_data_chunk_get_column_count(duckdb_data_chunk chunk) {
  auto *ch = chunk ? (ChunkImpl *)chunk->internal : nullptr;
  return ch ? (idx_t)ch->vecs.size() : 0;
}

idx_t duckdb_data_chunk_get_size(duckdb_data_chunk chunk) {
  auto *ch = chunk ? (ChunkImpl *)chunk->internal : nullptr;
  return ch ? ch->size : 0;
}

duckdb_vector duckdb_data_chunk_get_vector(duckdb_data_chunk chunk,
                                           idx_t col_idx) {
  auto *ch = chunk ? (ChunkImpl *)chunk->internal : nullptr;
  if (!ch || col_idx >= ch->vecs.size()) return nullptr;
  build_vec(ch, col_idx);
  // a vector handle IS (chunk, col): pack col into the pointer pair,
  // once per column; the chunk frees it
  if (ch->handles.size() < ch->vecs.size()) ch->handles.resize(ch->vecs.size(), nullptr);
  if (!ch->handles[col_idx]) {
    auto *pair = new std::pair<ChunkImpl *, idx_t>(ch, col_idx);
    ch->handles[col_idx] = new _duckdb_vector{pair};
    live_vectors++;
  }
  return (duckdb_vector)ch->handles[col_idx];
}

long duckdb_tpu_torch_live_vectors(void) { return live_vectors; }

static VecBuf *vecbuf(duckdb_vector v) {
  if (!v) return nullptr;
  auto *p = (std::pair<ChunkImpl *, idx_t> *)v->internal;
  return &p->first->vecs[p->second];
}

duckdb_logical_type duckdb_vector_get_column_type(duckdb_vector vector) {
  VecBuf *vb = vecbuf(vector);
  return vb ? wrap_lt(clone_lt(&vb->type)) : nullptr;
}

void *duckdb_vector_get_data(duckdb_vector vector) {
  VecBuf *vb = vecbuf(vector);
  return vb ? (void *)vb->data.data() : nullptr;
}

uint64_t *duckdb_vector_get_validity(duckdb_vector vector) {
  VecBuf *vb = vecbuf(vector);
  return vb ? vb->validity.data() : nullptr;
}

bool duckdb_validity_row_is_valid(uint64_t *validity, idx_t row) {
  if (!validity) return true;
  return (validity[row / 64] >> (row % 64)) & 1;
}

void duckdb_validity_set_row_validity(uint64_t *validity, idx_t row,
                                      bool valid) {
  if (!validity) return;
  if (valid) validity[row / 64] |= 1ULL << (row % 64);
  else validity[row / 64] &= ~(1ULL << (row % 64));
}

const char *duckdb_string_t_data(duckdb_string_t *string) {
  if (!string) return nullptr;
  return string->value.inlined.length <= 12 ? string->value.inlined.inlined
                                            : string->value.pointer.ptr;
}

uint32_t duckdb_string_t_length(duckdb_string_t string) {
  return string.value.inlined.length;
}

/* -- prepared statements ----------------------------------------------------- */

duckdb_state duckdb_prepare(duckdb_connection connection, const char *query,
                            duckdb_prepared_statement *out) {
  GIL g;
  auto *ci = (ConnectionImpl *)connection->internal;
  PyObject *stmt =
      PyObject_CallMethod(bridge(), "prepare", "Os", ci->con, query);
  auto *pi = new PreparedImpl();
  if (!stmt) {
    pi->error = py_err();
    *out = (duckdb_prepared_statement) new _duckdb_prepared{pi};
    return DuckDBError;
  }
  pi->stmt = stmt;
  *out = (duckdb_prepared_statement) new _duckdb_prepared{pi};
  return DuckDBSuccess;
}

void duckdb_destroy_prepare(duckdb_prepared_statement *stmt) {
  if (stmt && *stmt) {
    delete (PreparedImpl *)(*stmt)->internal;
    delete *stmt;
    *stmt = nullptr;
  }
}

const char *duckdb_prepare_error(duckdb_prepared_statement stmt) {
  auto *pi = stmt ? (PreparedImpl *)stmt->internal : nullptr;
  return (pi && !pi->error.empty()) ? pi->error.c_str() : nullptr;
}

idx_t duckdb_nparams(duckdb_prepared_statement stmt) {
  GIL g;
  auto *pi = (PreparedImpl *)stmt->internal;
  if (!pi->stmt) return 0;
  PyObject *n = PyObject_CallMethod(bridge(), "nparams", "O", pi->stmt);
  if (!n) {
    PyErr_Clear();
    return 0;
  }
  idx_t out = (idx_t)PyLong_AsUnsignedLongLong(n);
  Py_DECREF(n);
  return out;
}

duckdb_state duckdb_clear_bindings(duckdb_prepared_statement stmt) {
  GIL g;
  auto *pi = (PreparedImpl *)stmt->internal;
  for (auto *p : pi->params) Py_XDECREF(p);
  pi->params.clear();
  return DuckDBSuccess;
}

static duckdb_state bind_obj(duckdb_prepared_statement stmt, idx_t idx,
                             PyObject *v /*stolen*/) {
  if (!v) {
    PyErr_Clear();
    return DuckDBError;
  }
  ((PreparedImpl *)stmt->internal)->set(idx, v);
  return DuckDBSuccess;
}

duckdb_state duckdb_bind_boolean(duckdb_prepared_statement s, idx_t i,
                                 bool v) {
  GIL g;
  return bind_obj(s, i, PyBool_FromLong(v));
}
duckdb_state duckdb_bind_int8(duckdb_prepared_statement s, idx_t i,
                              int8_t v) {
  GIL g;
  return bind_obj(s, i, PyLong_FromLong(v));
}
duckdb_state duckdb_bind_int16(duckdb_prepared_statement s, idx_t i,
                               int16_t v) {
  GIL g;
  return bind_obj(s, i, PyLong_FromLong(v));
}
duckdb_state duckdb_bind_int32(duckdb_prepared_statement s, idx_t i,
                               int32_t v) {
  GIL g;
  return bind_obj(s, i, PyLong_FromLong(v));
}
duckdb_state duckdb_bind_int64(duckdb_prepared_statement s, idx_t i,
                               int64_t v) {
  GIL g;
  return bind_obj(s, i, PyLong_FromLongLong(v));
}
duckdb_state duckdb_bind_uint8(duckdb_prepared_statement s, idx_t i,
                               uint8_t v) {
  GIL g;
  return bind_obj(s, i, PyLong_FromUnsignedLong(v));
}
duckdb_state duckdb_bind_uint16(duckdb_prepared_statement s, idx_t i,
                                uint16_t v) {
  GIL g;
  return bind_obj(s, i, PyLong_FromUnsignedLong(v));
}
duckdb_state duckdb_bind_uint32(duckdb_prepared_statement s, idx_t i,
                                uint32_t v) {
  GIL g;
  return bind_obj(s, i, PyLong_FromUnsignedLong(v));
}
duckdb_state duckdb_bind_uint64(duckdb_prepared_statement s, idx_t i,
                                uint64_t v) {
  GIL g;
  return bind_obj(s, i, PyLong_FromUnsignedLongLong(v));
}
duckdb_state duckdb_bind_float(duckdb_prepared_statement s, idx_t i,
                               float v) {
  GIL g;
  return bind_obj(s, i, PyFloat_FromDouble(v));
}
duckdb_state duckdb_bind_double(duckdb_prepared_statement s, idx_t i,
                                double v) {
  GIL g;
  return bind_obj(s, i, PyFloat_FromDouble(v));
}

duckdb_state duckdb_bind_hugeint(duckdb_prepared_statement s, idx_t i,
                                 duckdb_hugeint v) {
  GIL g;
  // (upper << 64) | lower as an exact Python int
  PyObject *up = PyLong_FromLongLong(v.upper);
  PyObject *shift = PyLong_FromLong(64);
  PyObject *hi = PyNumber_Lshift(up, shift);
  PyObject *lo = PyLong_FromUnsignedLongLong(v.lower);
  PyObject *sum = hi && lo ? PyNumber_Add(hi, lo) : nullptr;
  Py_XDECREF(up);
  Py_XDECREF(shift);
  Py_XDECREF(hi);
  Py_XDECREF(lo);
  return bind_obj(s, i, sum);
}

duckdb_state duckdb_bind_date(duckdb_prepared_statement s, idx_t i,
                              duckdb_date v) {
  GIL g;
  return bind_obj(s, i,
                  PyObject_CallMethod(bridge(), "make_date", "i", v.days));
}
duckdb_state duckdb_bind_time(duckdb_prepared_statement s, idx_t i,
                              duckdb_time v) {
  GIL g;
  return bind_obj(s, i,
                  PyObject_CallMethod(bridge(), "make_time", "L", v.micros));
}
duckdb_state duckdb_bind_timestamp(duckdb_prepared_statement s, idx_t i,
                                   duckdb_timestamp v) {
  GIL g;
  return bind_obj(
      s, i, PyObject_CallMethod(bridge(), "make_timestamp", "L", v.micros));
}
duckdb_state duckdb_bind_interval(duckdb_prepared_statement s, idx_t i,
                                  duckdb_interval v) {
  GIL g;
  return bind_obj(s, i,
                  PyObject_CallMethod(bridge(), "make_interval", "iiL",
                                      v.months, v.days, v.micros));
}

duckdb_state duckdb_bind_varchar(duckdb_prepared_statement stmt, idx_t idx,
                                 const char *val) {
  GIL g;
  return bind_obj(stmt, idx, PyUnicode_FromString(val));
}

duckdb_state duckdb_bind_varchar_length(duckdb_prepared_statement stmt,
                                        idx_t idx, const char *val,
                                        idx_t length) {
  GIL g;
  return bind_obj(stmt, idx,
                  PyUnicode_FromStringAndSize(val, (Py_ssize_t)length));
}

duckdb_state duckdb_bind_blob(duckdb_prepared_statement stmt, idx_t idx,
                              const void *data, idx_t length) {
  GIL g;
  return bind_obj(stmt, idx,
                  PyBytes_FromStringAndSize((const char *)data,
                                            (Py_ssize_t)length));
}

duckdb_state duckdb_bind_null(duckdb_prepared_statement stmt, idx_t idx) {
  GIL g;
  Py_INCREF(Py_None);
  ((PreparedImpl *)stmt->internal)->set(idx, Py_None);
  return DuckDBSuccess;
}

duckdb_state duckdb_bind_value(duckdb_prepared_statement stmt, idx_t idx,
                               duckdb_value v) {
  Val *x = val(v);
  if (!x || x->is_null) return duckdb_bind_null(stmt, idx);
  switch (x->id) {
    case DUCKDB_TYPE_BOOLEAN:
      return duckdb_bind_boolean(stmt, idx, x->i != 0);
    case DUCKDB_TYPE_FLOAT:
    case DUCKDB_TYPE_DOUBLE:
      return duckdb_bind_double(stmt, idx, x->d);
    case DUCKDB_TYPE_VARCHAR:
      return duckdb_bind_varchar_length(stmt, idx, x->s.data(),
                                        (idx_t)x->s.size());
    case DUCKDB_TYPE_DATE: {
      duckdb_date d = {(int32_t)x->i};
      return duckdb_bind_date(stmt, idx, d);
    }
    case DUCKDB_TYPE_TIME: {
      duckdb_time t = {x->i};
      return duckdb_bind_time(stmt, idx, t);
    }
    case DUCKDB_TYPE_TIMESTAMP: {
      duckdb_timestamp t = {x->i};
      return duckdb_bind_timestamp(stmt, idx, t);
    }
    case DUCKDB_TYPE_INTERVAL:
      return duckdb_bind_interval(stmt, idx, x->iv);
    case DUCKDB_TYPE_HUGEINT:
      return duckdb_bind_hugeint(stmt, idx, x->h);
    case DUCKDB_TYPE_UBIGINT:
      return duckdb_bind_uint64(stmt, idx, x->u);
    default:
      return duckdb_bind_int64(stmt, idx, x->i);
  }
}

duckdb_state duckdb_execute_prepared(duckdb_prepared_statement stmt,
                                     duckdb_result *out_result) {
  GIL g;
  auto *pi = (PreparedImpl *)stmt->internal;
  if (!pi->stmt) return DuckDBError;
  PyObject *params = PyList_New((Py_ssize_t)pi->params.size());
  for (size_t i = 0; i < pi->params.size(); i++) {
    PyObject *p = pi->params[i] ? pi->params[i] : Py_None;
    Py_INCREF(p);
    PyList_SetItem(params, (Py_ssize_t)i, p);
  }
  PyObject *res = PyObject_CallMethod(bridge(), "run_prepared", "OO",
                                      pi->stmt, params);
  Py_DECREF(params);
  return run_sql_object(res, out_result);
}

/* -- appender ----------------------------------------------------------------- */

duckdb_state duckdb_appender_create(duckdb_connection connection,
                                    const char *schema, const char *table,
                                    duckdb_appender *out) {
  (void)schema;
  GIL g;
  auto *ci = (ConnectionImpl *)connection->internal;
  PyObject *app = PyObject_CallMethod(bridge(), "appender_create", "Os",
                                      ci->con, table);
  auto *ai = new AppenderImpl();
  if (!app) {
    ai->error = py_err();
    *out = (duckdb_appender) new _duckdb_appender{ai};
    return DuckDBError;
  }
  ai->app = app;
  *out = (duckdb_appender) new _duckdb_appender{ai};
  return DuckDBSuccess;
}

const char *duckdb_appender_error(duckdb_appender appender) {
  auto *ai = appender ? (AppenderImpl *)appender->internal : nullptr;
  return (ai && !ai->error.empty()) ? ai->error.c_str() : nullptr;
}

idx_t duckdb_appender_column_count(duckdb_appender appender) {
  GIL g;
  auto *ai = (AppenderImpl *)appender->internal;
  if (!ai->app) return 0;
  PyObject *n =
      PyObject_CallMethod(bridge(), "appender_ncols", "O", ai->app);
  if (!n) {
    PyErr_Clear();
    return 0;
  }
  idx_t out = (idx_t)PyLong_AsUnsignedLongLong(n);
  Py_DECREF(n);
  return out;
}

static duckdb_state append_obj(duckdb_appender appender, PyObject *v) {
  if (!v) {
    PyErr_Clear();
    return DuckDBError;
  }
  ((AppenderImpl *)appender->internal)->row.push_back(v);
  return DuckDBSuccess;
}

duckdb_state duckdb_append_bool(duckdb_appender a, bool v) {
  GIL g;
  return append_obj(a, PyBool_FromLong(v));
}
duckdb_state duckdb_append_int8(duckdb_appender a, int8_t v) {
  GIL g;
  return append_obj(a, PyLong_FromLong(v));
}
duckdb_state duckdb_append_int16(duckdb_appender a, int16_t v) {
  GIL g;
  return append_obj(a, PyLong_FromLong(v));
}
duckdb_state duckdb_append_int32(duckdb_appender a, int32_t v) {
  GIL g;
  return append_obj(a, PyLong_FromLong(v));
}
duckdb_state duckdb_append_int64(duckdb_appender a, int64_t v) {
  GIL g;
  return append_obj(a, PyLong_FromLongLong(v));
}
duckdb_state duckdb_append_uint8(duckdb_appender a, uint8_t v) {
  GIL g;
  return append_obj(a, PyLong_FromUnsignedLong(v));
}
duckdb_state duckdb_append_uint16(duckdb_appender a, uint16_t v) {
  GIL g;
  return append_obj(a, PyLong_FromUnsignedLong(v));
}
duckdb_state duckdb_append_uint32(duckdb_appender a, uint32_t v) {
  GIL g;
  return append_obj(a, PyLong_FromUnsignedLong(v));
}
duckdb_state duckdb_append_uint64(duckdb_appender a, uint64_t v) {
  GIL g;
  return append_obj(a, PyLong_FromUnsignedLongLong(v));
}
duckdb_state duckdb_append_float(duckdb_appender a, float v) {
  GIL g;
  return append_obj(a, PyFloat_FromDouble(v));
}
duckdb_state duckdb_append_double(duckdb_appender a, double v) {
  GIL g;
  return append_obj(a, PyFloat_FromDouble(v));
}

duckdb_state duckdb_append_hugeint(duckdb_appender a, duckdb_hugeint v) {
  GIL g;
  PyObject *up = PyLong_FromLongLong(v.upper);
  PyObject *shift = PyLong_FromLong(64);
  PyObject *hi = PyNumber_Lshift(up, shift);
  PyObject *lo = PyLong_FromUnsignedLongLong(v.lower);
  PyObject *sum = hi && lo ? PyNumber_Add(hi, lo) : nullptr;
  Py_XDECREF(up);
  Py_XDECREF(shift);
  Py_XDECREF(hi);
  Py_XDECREF(lo);
  return append_obj(a, sum);
}

duckdb_state duckdb_append_date(duckdb_appender a, duckdb_date v) {
  GIL g;
  return append_obj(a,
                    PyObject_CallMethod(bridge(), "make_date", "i", v.days));
}
duckdb_state duckdb_append_time(duckdb_appender a, duckdb_time v) {
  GIL g;
  return append_obj(
      a, PyObject_CallMethod(bridge(), "make_time", "L", v.micros));
}
duckdb_state duckdb_append_timestamp(duckdb_appender a, duckdb_timestamp v) {
  GIL g;
  return append_obj(
      a, PyObject_CallMethod(bridge(), "make_timestamp", "L", v.micros));
}
duckdb_state duckdb_append_interval(duckdb_appender a, duckdb_interval v) {
  GIL g;
  return append_obj(a, PyObject_CallMethod(bridge(), "make_interval", "iiL",
                                           v.months, v.days, v.micros));
}

duckdb_state duckdb_append_varchar(duckdb_appender a, const char *v) {
  GIL g;
  return append_obj(a, PyUnicode_FromString(v));
}

duckdb_state duckdb_append_varchar_length(duckdb_appender a, const char *v,
                                          idx_t length) {
  GIL g;
  return append_obj(a, PyUnicode_FromStringAndSize(v, (Py_ssize_t)length));
}

duckdb_state duckdb_append_blob(duckdb_appender a, const void *data,
                                idx_t length) {
  GIL g;
  return append_obj(a, PyBytes_FromStringAndSize((const char *)data,
                                                 (Py_ssize_t)length));
}

duckdb_state duckdb_append_null(duckdb_appender a) {
  GIL g;
  Py_INCREF(Py_None);
  return append_obj(a, Py_None);
}

duckdb_state duckdb_append_value(duckdb_appender a, duckdb_value v) {
  Val *x = val(v);
  if (!x || x->is_null) return duckdb_append_null(a);
  switch (x->id) {
    case DUCKDB_TYPE_BOOLEAN:
      return duckdb_append_bool(a, x->i != 0);
    case DUCKDB_TYPE_FLOAT:
    case DUCKDB_TYPE_DOUBLE:
      return duckdb_append_double(a, x->d);
    case DUCKDB_TYPE_VARCHAR:
      return duckdb_append_varchar_length(a, x->s.data(),
                                          (idx_t)x->s.size());
    case DUCKDB_TYPE_DATE: {
      duckdb_date d = {(int32_t)x->i};
      return duckdb_append_date(a, d);
    }
    case DUCKDB_TYPE_TIME: {
      duckdb_time t = {x->i};
      return duckdb_append_time(a, t);
    }
    case DUCKDB_TYPE_TIMESTAMP: {
      duckdb_timestamp t = {x->i};
      return duckdb_append_timestamp(a, t);
    }
    case DUCKDB_TYPE_INTERVAL:
      return duckdb_append_interval(a, x->iv);
    case DUCKDB_TYPE_HUGEINT:
      return duckdb_append_hugeint(a, x->h);
    case DUCKDB_TYPE_UBIGINT:
      return duckdb_append_uint64(a, x->u);
    default:
      return duckdb_append_int64(a, x->i);
  }
}

duckdb_state duckdb_appender_end_row(duckdb_appender a) {
  GIL g;
  auto *ai = (AppenderImpl *)a->internal;
  PyObject *row = PyList_New((Py_ssize_t)ai->row.size());
  for (size_t i = 0; i < ai->row.size(); i++) {
    PyList_SetItem(row, (Py_ssize_t)i, ai->row[i]);  // steals
  }
  ai->row.clear();
  PyObject *r = PyObject_CallMethod(bridge(), "append_row", "OO", ai->app,
                                    row);
  Py_DECREF(row);
  if (!r) {
    ai->error = py_err();
    return DuckDBError;
  }
  Py_DECREF(r);
  return DuckDBSuccess;
}

duckdb_state duckdb_appender_flush(duckdb_appender a) {
  GIL g;
  auto *ai = (AppenderImpl *)a->internal;
  if (!ai->app) return DuckDBError;
  PyObject *r = PyObject_CallMethod(bridge(), "appender_flush", "O", ai->app);
  if (!r) {
    ai->error = py_err();
    return DuckDBError;
  }
  Py_DECREF(r);
  return DuckDBSuccess;
}

duckdb_state duckdb_appender_close(duckdb_appender a) {
  return duckdb_appender_flush(a);
}

duckdb_state duckdb_appender_destroy(duckdb_appender *a) {
  if (a && *a) {
    if (((AppenderImpl *)(*a)->internal)->app) duckdb_appender_flush(*a);
    delete (AppenderImpl *)(*a)->internal;
    delete *a;
    *a = nullptr;
  }
  return DuckDBSuccess;
}

}  // extern "C"
