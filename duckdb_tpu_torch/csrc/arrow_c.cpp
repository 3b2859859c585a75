// arrow_c: the Arrow C data and stream interface of the port
// (api/arrow_interop.py), built with the host C++ compiler and loaded with
// ctypes. Host code only: it runs no device work.
//
// Arrow's C interface is three plain C structs (ArrowSchema, ArrowArray,
// ArrowArrayStream, https://arrow.apache.org/docs/format/CDataInterface.html)
// handed between libraries as PyCapsules ("arrow_schema", "arrow_array",
// "arrow_array_stream"). So the port exports and imports Arrow data with no
// Arrow library: DuckDB's own ArrowConverter and ArrowAppender do the same
// (src/common/arrow/).
//
// Export: Python builds each column's buffers with numpy and hands them
// here; the structs made here own copies of them (64-byte aligned), and
// each struct's release callback frees what it owns: its buffers, its
// children and its dictionary. A stream owns its schema and its batches
// until a consumer takes them. A capsule's destructor releases a struct no
// consumer moved out of it (a capsule dropped unconsumed).
//
// Import: a consumer moves a producer's struct out of its capsule (the
// capsule's copy is marked released), reads it through ctypes, and
// releases it through the producer's own callback.
//
// arrowc_live() counts the private blocks of the structs made here that
// are not yet released (a test hook: 0 once every export is released).

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

struct ArrowSchema {
  const char *format;
  const char *name;
  const char *metadata;
  int64_t flags;
  int64_t n_children;
  struct ArrowSchema **children;
  struct ArrowSchema *dictionary;
  void (*release)(struct ArrowSchema *);
  void *private_data;
};

struct ArrowArray {
  int64_t length;
  int64_t null_count;
  int64_t offset;
  int64_t n_buffers;
  int64_t n_children;
  const void **buffers;
  struct ArrowArray **children;
  struct ArrowArray *dictionary;
  void (*release)(struct ArrowArray *);
  void *private_data;
};

struct ArrowArrayStream {
  int (*get_schema)(struct ArrowArrayStream *, struct ArrowSchema *out);
  int (*get_next)(struct ArrowArrayStream *, struct ArrowArray *out);
  const char *(*get_last_error)(struct ArrowArrayStream *);
  void (*release)(struct ArrowArrayStream *);
  void *private_data;
};

// the CPython calls a capsule destructor makes; they resolve against the
// interpreter that loads this library (which is what calls a destructor)
typedef struct _object PyObject;
void *PyCapsule_GetPointer(PyObject *capsule, const char *name);

}  // extern "C"

namespace {

std::atomic<long> live{0};

const char *const CAPSULE_NAMES[] = {"arrow_schema", "arrow_array", "arrow_array_stream"};

// -- schemas --------------------------------------------------------------------------
struct SchemaPriv {
  std::string format, name;
  std::vector<ArrowSchema *> children;
  ArrowSchema *dictionary = nullptr;
};

void release_schema(ArrowSchema *s) {
  if (!s || !s->release) return;
  auto *p = static_cast<SchemaPriv *>(s->private_data);
  for (auto *c : p->children) {
    if (c->release) c->release(c);
    delete c;
  }
  if (p->dictionary) {
    if (p->dictionary->release) p->dictionary->release(p->dictionary);
    delete p->dictionary;
  }
  delete p;
  s->release = nullptr;
  live--;
}

void init_schema(ArrowSchema *s, const char *format, const char *name, int64_t flags,
                 int64_t n_children) {
  auto *p = new SchemaPriv();
  live++;
  p->format = format ? format : "";
  p->name = name ? name : "";
  p->children.resize(static_cast<size_t>(n_children), nullptr);
  for (auto &c : p->children) {
    c = new ArrowSchema();
    memset(c, 0, sizeof(ArrowSchema));
  }
  s->format = p->format.c_str();
  s->name = p->name.c_str();
  s->metadata = nullptr;
  s->flags = flags;
  s->n_children = n_children;
  s->children = n_children ? p->children.data() : nullptr;
  s->dictionary = nullptr;
  s->release = release_schema;
  s->private_data = p;
}

// a deep copy of a schema made here (a stream hands out a copy each call)
void copy_schema(const ArrowSchema *src, ArrowSchema *dst) {
  init_schema(dst, src->format, src->name, src->flags, src->n_children);
  auto *p = static_cast<SchemaPriv *>(dst->private_data);
  for (int64_t i = 0; i < src->n_children; i++) copy_schema(src->children[i], p->children[i]);
  if (src->dictionary) {
    p->dictionary = new ArrowSchema();
    copy_schema(src->dictionary, p->dictionary);
    dst->dictionary = p->dictionary;
  }
}

// -- arrays ---------------------------------------------------------------------------
struct ArrayPriv {
  std::vector<void *> owned;         // the buffers' memory
  std::vector<const void *> buffers;  // what `buffers` points at
  std::vector<ArrowArray *> children;
  ArrowArray *dictionary = nullptr;
};

void release_array(ArrowArray *a) {
  if (!a || !a->release) return;
  auto *p = static_cast<ArrayPriv *>(a->private_data);
  for (void *b : p->owned) free(b);
  for (auto *c : p->children) {
    if (c->release) c->release(c);
    delete c;
  }
  if (p->dictionary) {
    if (p->dictionary->release) p->dictionary->release(p->dictionary);
    delete p->dictionary;
  }
  delete p;
  a->release = nullptr;
  live--;
}

// -- streams --------------------------------------------------------------------------
struct StreamPriv {
  ArrowSchema schema;
  std::vector<ArrowArray> batches;
  size_t next = 0;
  std::string error;
};

int stream_get_schema(ArrowArrayStream *s, ArrowSchema *out) {
  auto *p = static_cast<StreamPriv *>(s->private_data);
  copy_schema(&p->schema, out);
  return 0;
}

int stream_get_next(ArrowArrayStream *s, ArrowArray *out) {
  auto *p = static_cast<StreamPriv *>(s->private_data);
  if (p->next < p->batches.size()) {
    *out = p->batches[p->next];  // moved: the consumer releases it
    p->batches[p->next].release = nullptr;
    p->next++;
  } else {
    memset(out, 0, sizeof(ArrowArray));  // the end of the stream
  }
  return 0;
}

const char *stream_last_error(ArrowArrayStream *s) {
  auto *p = static_cast<StreamPriv *>(s->private_data);
  return p->error.empty() ? nullptr : p->error.c_str();
}

void release_stream(ArrowArrayStream *s) {
  if (!s || !s->release) return;
  auto *p = static_cast<StreamPriv *>(s->private_data);
  for (auto &b : p->batches) release_array(&b);
  release_schema(&p->schema);
  delete p;
  s->release = nullptr;
  live--;
}

// -- capsule destructors: release what no consumer moved out ----------------------------
void drop_schema_capsule(PyObject *cap) {
  auto *s = static_cast<ArrowSchema *>(PyCapsule_GetPointer(cap, CAPSULE_NAMES[0]));
  if (!s) return;
  if (s->release) s->release(s);
  free(s);
}

void drop_array_capsule(PyObject *cap) {
  auto *a = static_cast<ArrowArray *>(PyCapsule_GetPointer(cap, CAPSULE_NAMES[1]));
  if (!a) return;
  if (a->release) a->release(a);
  free(a);
}

void drop_stream_capsule(PyObject *cap) {
  auto *s = static_cast<ArrowArrayStream *>(PyCapsule_GetPointer(cap, CAPSULE_NAMES[2]));
  if (!s) return;
  if (s->release) s->release(s);
  free(s);
}

template <typename T>
T *alloc_struct() {
  auto *p = static_cast<T *>(calloc(1, sizeof(T)));
  return p;
}

}  // namespace

extern "C" {

long arrowc_live() { return live.load(); }

const char *arrowc_capsule_name(int kind) { return CAPSULE_NAMES[kind]; }

// the destructor of a capsule of each kind (0 schema, 1 array, 2 stream)
void *arrowc_capsule_destructor(int kind) {
  if (kind == 0) return reinterpret_cast<void *>(&drop_schema_capsule);
  if (kind == 1) return reinterpret_cast<void *>(&drop_array_capsule);
  return reinterpret_cast<void *>(&drop_stream_capsule);
}

// -- building an export ---------------------------------------------------------------
// A new schema node (a malloc'd struct a capsule or a parent can own).
ArrowSchema *arrowc_schema_new(const char *format, const char *name, int64_t flags,
                               int64_t n_children) {
  auto *s = alloc_struct<ArrowSchema>();
  init_schema(s, format, name, flags, n_children);
  return s;
}

// child i of parent becomes *child (moved; the child's shell is freed)
void arrowc_schema_set_child(ArrowSchema *parent, int64_t i, ArrowSchema *child) {
  auto *p = static_cast<SchemaPriv *>(parent->private_data);
  *p->children[static_cast<size_t>(i)] = *child;
  child->release = nullptr;
  free(child);
}

void arrowc_schema_set_dictionary(ArrowSchema *s, ArrowSchema *dict) {
  auto *p = static_cast<SchemaPriv *>(s->private_data);
  p->dictionary = new ArrowSchema(*dict);
  dict->release = nullptr;
  free(dict);
  s->dictionary = p->dictionary;
}

ArrowArray *arrowc_array_new(int64_t length, int64_t null_count, int64_t n_buffers,
                             int64_t n_children) {
  auto *a = alloc_struct<ArrowArray>();
  auto *p = new ArrayPriv();
  live++;
  p->buffers.assign(static_cast<size_t>(n_buffers), nullptr);
  p->children.resize(static_cast<size_t>(n_children), nullptr);
  for (auto &c : p->children) c = new ArrowArray();
  a->length = length;
  a->null_count = null_count;
  a->offset = 0;
  a->n_buffers = n_buffers;
  a->n_children = n_children;
  a->buffers = n_buffers ? p->buffers.data() : nullptr;
  a->children = n_children ? p->children.data() : nullptr;
  a->dictionary = nullptr;
  a->release = release_array;
  a->private_data = p;
  return a;
}

// buffer i becomes an aligned copy of nbytes at src (src NULL: no buffer,
// as an absent validity bitmap is)
int arrowc_array_set_buffer(ArrowArray *a, int64_t i, const void *src, int64_t nbytes) {
  auto *p = static_cast<ArrayPriv *>(a->private_data);
  if (!src) {
    p->buffers[static_cast<size_t>(i)] = nullptr;
    return 0;
  }
  size_t size = static_cast<size_t>(nbytes > 0 ? nbytes : 1);
  void *mem = nullptr;
  if (posix_memalign(&mem, 64, (size + 63) / 64 * 64) != 0) return -1;
  if (nbytes > 0) memcpy(mem, src, static_cast<size_t>(nbytes));
  p->owned.push_back(mem);
  p->buffers[static_cast<size_t>(i)] = mem;
  return 0;
}

void arrowc_array_set_child(ArrowArray *parent, int64_t i, ArrowArray *child) {
  auto *p = static_cast<ArrayPriv *>(parent->private_data);
  *p->children[static_cast<size_t>(i)] = *child;
  child->release = nullptr;
  free(child);
}

void arrowc_array_set_dictionary(ArrowArray *a, ArrowArray *dict) {
  auto *p = static_cast<ArrayPriv *>(a->private_data);
  p->dictionary = new ArrowArray(*dict);
  dict->release = nullptr;
  free(dict);
  a->dictionary = p->dictionary;
}

// a stream over `schema` (moved in; its shell is freed), no batches yet
ArrowArrayStream *arrowc_stream_new(ArrowSchema *schema) {
  auto *s = alloc_struct<ArrowArrayStream>();
  auto *p = new StreamPriv();
  live++;
  p->schema = *schema;
  schema->release = nullptr;
  free(schema);
  s->get_schema = stream_get_schema;
  s->get_next = stream_get_next;
  s->get_last_error = stream_last_error;
  s->release = release_stream;
  s->private_data = p;
  return s;
}

// the stream's next batch becomes *batch (moved in; its shell is freed)
void arrowc_stream_push(ArrowArrayStream *s, ArrowArray *batch) {
  auto *p = static_cast<StreamPriv *>(s->private_data);
  p->batches.push_back(*batch);
  batch->release = nullptr;
  free(batch);
}

// -- reading an import ----------------------------------------------------------------
// A producer's struct moved into a new shell this library frees: the
// source (a capsule's) is marked released, as the interface's move is.
ArrowSchema *arrowc_schema_take(ArrowSchema *src) {
  auto *s = alloc_struct<ArrowSchema>();
  *s = *src;
  src->release = nullptr;
  return s;
}

ArrowArray *arrowc_array_take(ArrowArray *src) {
  auto *a = alloc_struct<ArrowArray>();
  *a = *src;
  src->release = nullptr;
  return a;
}

ArrowArrayStream *arrowc_stream_take(ArrowArrayStream *src) {
  auto *s = alloc_struct<ArrowArrayStream>();
  *s = *src;
  src->release = nullptr;
  return s;
}

// a stream's schema and next batch into new shells (a batch of NULL
// release is the end); the producer's error code is returned
int arrowc_stream_get_schema(ArrowArrayStream *s, ArrowSchema **out) {
  *out = alloc_struct<ArrowSchema>();
  return s->get_schema(s, *out);
}

int arrowc_stream_get_next(ArrowArrayStream *s, ArrowArray **out) {
  *out = alloc_struct<ArrowArray>();
  return s->get_next(s, *out);
}

const char *arrowc_stream_error(ArrowArrayStream *s) {
  return s->get_last_error ? s->get_last_error(s) : nullptr;
}

// release a struct through its own callback, then free its shell
void arrowc_schema_free(ArrowSchema *s) {
  if (!s) return;
  if (s->release) s->release(s);
  free(s);
}

void arrowc_array_free(ArrowArray *a) {
  if (!a) return;
  if (a->release) a->release(a);
  free(a);
}

void arrowc_stream_free(ArrowArrayStream *s) {
  if (!s) return;
  if (s->release) s->release(s);
  free(s);
}

}  // extern "C"
