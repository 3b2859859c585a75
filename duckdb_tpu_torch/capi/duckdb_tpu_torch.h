/* duckdb_tpu_torch C API — the embedding surface of the PyTorch/CUDA port.
 *
 * A copy of the JAX package's header (duckdb_tpu/capi/duckdb_tpu.h), a
 * shape-compatible subset of DuckDB's C API (src/include/duckdb.h):
 * open/connect/query lifecycle, result introspection, typed value
 * accessors, date/time/hugeint/decimal helpers, data chunks + vectors,
 * logical types, values, configuration, prepared statements and the
 * appender. The implementation (capi.cpp) calls the port through the
 * embedded CPython interpreter; results are materialized into C-owned
 * buffers so accessors never re-enter Python.
 *
 * Layout mirrors DuckDB's header's section order so an embedding written
 * against DuckDB maps function-for-function.
 */
#ifndef DUCKDB_TPU_TORCH_C_H
#define DUCKDB_TPU_TORCH_C_H

#include <stdbool.h>
#include <stdint.h>
#include <stdlib.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef uint64_t idx_t;

typedef enum { DuckDBSuccess = 0, DuckDBError = 1 } duckdb_state;

/* enum values match DuckDB DUCKDB_TYPE_* ids (duckdb.h) */
typedef enum {
  DUCKDB_TYPE_INVALID = 0,
  DUCKDB_TYPE_BOOLEAN = 1,
  DUCKDB_TYPE_TINYINT = 2,
  DUCKDB_TYPE_SMALLINT = 3,
  DUCKDB_TYPE_INTEGER = 4,
  DUCKDB_TYPE_BIGINT = 5,
  DUCKDB_TYPE_UTINYINT = 6,
  DUCKDB_TYPE_USMALLINT = 7,
  DUCKDB_TYPE_UINTEGER = 8,
  DUCKDB_TYPE_UBIGINT = 9,
  DUCKDB_TYPE_FLOAT = 10,
  DUCKDB_TYPE_DOUBLE = 11,
  DUCKDB_TYPE_TIMESTAMP = 12,
  DUCKDB_TYPE_DATE = 13,
  DUCKDB_TYPE_TIME = 14,
  DUCKDB_TYPE_INTERVAL = 15,
  DUCKDB_TYPE_HUGEINT = 16,
  DUCKDB_TYPE_VARCHAR = 17,
  DUCKDB_TYPE_BLOB = 18,
  DUCKDB_TYPE_DECIMAL = 19,
  DUCKDB_TYPE_TIMESTAMP_S = 20,
  DUCKDB_TYPE_TIMESTAMP_MS = 21,
  DUCKDB_TYPE_TIMESTAMP_NS = 22,
  DUCKDB_TYPE_ENUM = 23,
  DUCKDB_TYPE_LIST = 24,
  DUCKDB_TYPE_STRUCT = 25,
  DUCKDB_TYPE_MAP = 26,
  DUCKDB_TYPE_ARRAY = 33,
  DUCKDB_TYPE_UUID = 27,
  DUCKDB_TYPE_UNION = 28,
  DUCKDB_TYPE_BIT = 29,
  DUCKDB_TYPE_TIMESTAMP_TZ = 32,
} duckdb_type;

/* -- value structs (ABI-identical to DuckDB) ------------------------ */
typedef struct {
  int32_t days; /* days since 1970-01-01 */
} duckdb_date;
typedef struct {
  int32_t year;
  int8_t month;
  int8_t day;
} duckdb_date_struct;
typedef struct {
  int64_t micros; /* microseconds since 00:00:00 */
} duckdb_time;
typedef struct {
  int8_t hour;
  int8_t min;
  int8_t sec;
  int32_t micros;
} duckdb_time_struct;
typedef struct {
  int64_t micros; /* microseconds since 1970-01-01 00:00:00 UTC */
} duckdb_timestamp;
typedef struct {
  duckdb_date_struct date;
  duckdb_time_struct time;
} duckdb_timestamp_struct;
typedef struct {
  int32_t months;
  int32_t days;
  int64_t micros;
} duckdb_interval;
typedef struct {
  uint64_t lower;
  int64_t upper;
} duckdb_hugeint;
typedef struct {
  uint8_t width;
  uint8_t scale;
  duckdb_hugeint value;
} duckdb_decimal;
typedef struct {
  char *data;  /* malloc'd; free with duckdb_free */
  idx_t size;
} duckdb_string;
typedef struct {
  void *data;  /* malloc'd; free with duckdb_free */
  idx_t size;
} duckdb_blob;
/* vector string cells: DuckDB's 16-byte string_t layout */
typedef struct {
  union {
    struct {
      uint32_t length;
      char prefix[4];
      const char *ptr;
    } pointer;
    struct {
      uint32_t length;
      char inlined[12];
    } inlined;
  } value;
} duckdb_string_t;

typedef struct _duckdb_database { void *internal; } * duckdb_database;
typedef struct _duckdb_connection { void *internal; } * duckdb_connection;
typedef struct _duckdb_prepared { void *internal; } * duckdb_prepared_statement;
typedef struct _duckdb_appender { void *internal; } * duckdb_appender;
typedef struct _duckdb_config { void *internal; } * duckdb_config;
typedef struct _duckdb_logical_type { void *internal; } * duckdb_logical_type;
typedef struct _duckdb_data_chunk { void *internal; } * duckdb_data_chunk;
typedef struct _duckdb_vector { void *internal; } * duckdb_vector;
typedef struct _duckdb_value { void *internal; } * duckdb_value;

typedef struct { void *internal_data; } duckdb_result;

#define DUCKDB_TPU_TORCH_VECTOR_SIZE 2048

/* -- open / close ---------------------------------------------------------- */
duckdb_state duckdb_open(const char *path, duckdb_database *out_database);
duckdb_state duckdb_open_ext(const char *path, duckdb_database *out_database,
                             duckdb_config config, char **out_error);
void duckdb_close(duckdb_database *database);
duckdb_state duckdb_connect(duckdb_database database,
                            duckdb_connection *out_connection);
void duckdb_disconnect(duckdb_connection *connection);
const char *duckdb_library_version(void);
void duckdb_interrupt(duckdb_connection connection);

/* -- configuration --------------------------------------------------------- */
duckdb_state duckdb_create_config(duckdb_config *out_config);
size_t duckdb_config_count(void);
duckdb_state duckdb_get_config_flag(size_t index, const char **out_name,
                                    const char **out_description);
duckdb_state duckdb_set_config(duckdb_config config, const char *name,
                               const char *option);
void duckdb_destroy_config(duckdb_config *config);

/* -- query ----------------------------------------------------------------- */
duckdb_state duckdb_query(duckdb_connection connection, const char *query,
                          duckdb_result *out_result);
void duckdb_destroy_result(duckdb_result *result);
const char *duckdb_result_error(duckdb_result *result);

idx_t duckdb_column_count(duckdb_result *result);
idx_t duckdb_row_count(duckdb_result *result);
idx_t duckdb_rows_changed(duckdb_result *result);
const char *duckdb_column_name(duckdb_result *result, idx_t col);
duckdb_type duckdb_column_type(duckdb_result *result, idx_t col);
duckdb_logical_type duckdb_column_logical_type(duckdb_result *result,
                                               idx_t col);

/* -- typed value accessors (row-major random access) ----------------------- */
bool duckdb_value_is_null(duckdb_result *result, idx_t col, idx_t row);
bool duckdb_value_boolean(duckdb_result *result, idx_t col, idx_t row);
int8_t duckdb_value_int8(duckdb_result *result, idx_t col, idx_t row);
int16_t duckdb_value_int16(duckdb_result *result, idx_t col, idx_t row);
int32_t duckdb_value_int32(duckdb_result *result, idx_t col, idx_t row);
int64_t duckdb_value_int64(duckdb_result *result, idx_t col, idx_t row);
uint8_t duckdb_value_uint8(duckdb_result *result, idx_t col, idx_t row);
uint16_t duckdb_value_uint16(duckdb_result *result, idx_t col, idx_t row);
uint32_t duckdb_value_uint32(duckdb_result *result, idx_t col, idx_t row);
uint64_t duckdb_value_uint64(duckdb_result *result, idx_t col, idx_t row);
float duckdb_value_float(duckdb_result *result, idx_t col, idx_t row);
double duckdb_value_double(duckdb_result *result, idx_t col, idx_t row);
duckdb_hugeint duckdb_value_hugeint(duckdb_result *result, idx_t col,
                                    idx_t row);
duckdb_decimal duckdb_value_decimal(duckdb_result *result, idx_t col,
                                    idx_t row);
duckdb_date duckdb_value_date(duckdb_result *result, idx_t col, idx_t row);
duckdb_time duckdb_value_time(duckdb_result *result, idx_t col, idx_t row);
duckdb_timestamp duckdb_value_timestamp(duckdb_result *result, idx_t col,
                                        idx_t row);
duckdb_interval duckdb_value_interval(duckdb_result *result, idx_t col,
                                      idx_t row);
/* returns a malloc'd utf-8 string; free with duckdb_free */
char *duckdb_value_varchar(duckdb_result *result, idx_t col, idx_t row);
duckdb_string duckdb_value_string(duckdb_result *result, idx_t col, idx_t row);
duckdb_blob duckdb_value_blob(duckdb_result *result, idx_t col, idx_t row);
void duckdb_free(void *ptr);
idx_t duckdb_vector_size(void);

/* -- date / time / hugeint / decimal helpers (pure C, no engine) ----------- */
duckdb_date_struct duckdb_from_date(duckdb_date date);
duckdb_date duckdb_to_date(duckdb_date_struct date);
bool duckdb_is_finite_date(duckdb_date date);
duckdb_time_struct duckdb_from_time(duckdb_time time);
duckdb_time duckdb_to_time(duckdb_time_struct time);
duckdb_timestamp_struct duckdb_from_timestamp(duckdb_timestamp ts);
duckdb_timestamp duckdb_to_timestamp(duckdb_timestamp_struct ts);
bool duckdb_is_finite_timestamp(duckdb_timestamp ts);
double duckdb_hugeint_to_double(duckdb_hugeint val);
duckdb_hugeint duckdb_double_to_hugeint(double val);
double duckdb_decimal_to_double(duckdb_decimal val);

/* -- logical types ---------------------------------------------------------- */
duckdb_logical_type duckdb_create_logical_type(duckdb_type type);
duckdb_type duckdb_get_type_id(duckdb_logical_type type);
void duckdb_destroy_logical_type(duckdb_logical_type *type);
duckdb_logical_type duckdb_create_decimal_type(uint8_t width, uint8_t scale);
uint8_t duckdb_decimal_width(duckdb_logical_type type);
uint8_t duckdb_decimal_scale(duckdb_logical_type type);
duckdb_type duckdb_decimal_internal_type(duckdb_logical_type type);
duckdb_logical_type duckdb_create_list_type(duckdb_logical_type child);
duckdb_logical_type duckdb_list_type_child_type(duckdb_logical_type type);
duckdb_logical_type duckdb_create_array_type(duckdb_logical_type child,
                                             idx_t array_size);
idx_t duckdb_array_type_array_size(duckdb_logical_type type);
duckdb_logical_type duckdb_array_type_child_type(duckdb_logical_type type);
duckdb_logical_type duckdb_create_map_type(duckdb_logical_type key,
                                           duckdb_logical_type value);
duckdb_logical_type duckdb_map_type_key_type(duckdb_logical_type type);
duckdb_logical_type duckdb_map_type_value_type(duckdb_logical_type type);
duckdb_logical_type duckdb_create_struct_type(duckdb_logical_type *types,
                                              const char **names,
                                              idx_t count);
idx_t duckdb_struct_type_child_count(duckdb_logical_type type);
/* malloc'd; free with duckdb_free */
char *duckdb_struct_type_child_name(duckdb_logical_type type, idx_t index);
duckdb_logical_type duckdb_struct_type_child_type(duckdb_logical_type type,
                                                  idx_t index);

/* -- values ------------------------------------------------------------------ */
duckdb_value duckdb_create_varchar(const char *text);
duckdb_value duckdb_create_varchar_length(const char *text, idx_t length);
duckdb_value duckdb_create_bool(bool input);
duckdb_value duckdb_create_int8(int8_t input);
duckdb_value duckdb_create_int16(int16_t input);
duckdb_value duckdb_create_int32(int32_t input);
duckdb_value duckdb_create_int64(int64_t input);
duckdb_value duckdb_create_uint64(uint64_t input);
duckdb_value duckdb_create_float(float input);
duckdb_value duckdb_create_double(double input);
duckdb_value duckdb_create_date(duckdb_date input);
duckdb_value duckdb_create_time(duckdb_time input);
duckdb_value duckdb_create_timestamp(duckdb_timestamp input);
duckdb_value duckdb_create_interval(duckdb_interval input);
duckdb_value duckdb_create_hugeint(duckdb_hugeint input);
duckdb_value duckdb_create_null_value(void);
bool duckdb_is_null_value(duckdb_value value);
bool duckdb_get_bool(duckdb_value value);
int8_t duckdb_get_int8(duckdb_value value);
int16_t duckdb_get_int16(duckdb_value value);
int32_t duckdb_get_int32(duckdb_value value);
int64_t duckdb_get_int64(duckdb_value value);
uint64_t duckdb_get_uint64(duckdb_value value);
float duckdb_get_float(duckdb_value value);
double duckdb_get_double(duckdb_value value);
duckdb_date duckdb_get_date(duckdb_value value);
duckdb_time duckdb_get_time(duckdb_value value);
duckdb_timestamp duckdb_get_timestamp(duckdb_value value);
duckdb_interval duckdb_get_interval(duckdb_value value);
duckdb_hugeint duckdb_get_hugeint(duckdb_value value);
/* malloc'd; free with duckdb_free */
char *duckdb_get_varchar(duckdb_value value);
duckdb_logical_type duckdb_get_value_type(duckdb_value value);
void duckdb_destroy_value(duckdb_value *value);

/* -- data chunks + vectors ---------------------------------------------------
 * Chunk access over a materialized result: fixed 2048-row windows.
 * Numeric vectors expose width-faithful planes (INTEGER → int32_t*);
 * VARCHAR vectors expose DuckDB's 16-byte duckdb_string_t cells. */
idx_t duckdb_result_chunk_count(duckdb_result result);
duckdb_data_chunk duckdb_result_get_chunk(duckdb_result result,
                                          idx_t chunk_index);
duckdb_data_chunk duckdb_fetch_chunk(duckdb_result result);
void duckdb_destroy_data_chunk(duckdb_data_chunk *chunk);
idx_t duckdb_data_chunk_get_column_count(duckdb_data_chunk chunk);
idx_t duckdb_data_chunk_get_size(duckdb_data_chunk chunk);
duckdb_vector duckdb_data_chunk_get_vector(duckdb_data_chunk chunk,
                                           idx_t col_idx);
duckdb_logical_type duckdb_vector_get_column_type(duckdb_vector vector);
void *duckdb_vector_get_data(duckdb_vector vector);
uint64_t *duckdb_vector_get_validity(duckdb_vector vector);
bool duckdb_validity_row_is_valid(uint64_t *validity, idx_t row);
void duckdb_validity_set_row_validity(uint64_t *validity, idx_t row,
                                      bool valid);
const char *duckdb_string_t_data(duckdb_string_t *string);
uint32_t duckdb_string_t_length(duckdb_string_t string);

/* -- prepared statements ----------------------------------------------------- */
duckdb_state duckdb_prepare(duckdb_connection connection, const char *query,
                            duckdb_prepared_statement *out);
void duckdb_destroy_prepare(duckdb_prepared_statement *stmt);
const char *duckdb_prepare_error(duckdb_prepared_statement stmt);
idx_t duckdb_nparams(duckdb_prepared_statement stmt);
duckdb_state duckdb_clear_bindings(duckdb_prepared_statement stmt);
duckdb_state duckdb_bind_value(duckdb_prepared_statement stmt, idx_t idx,
                               duckdb_value val);
duckdb_state duckdb_bind_boolean(duckdb_prepared_statement stmt, idx_t idx,
                                 bool val);
duckdb_state duckdb_bind_int8(duckdb_prepared_statement stmt, idx_t idx,
                              int8_t val);
duckdb_state duckdb_bind_int16(duckdb_prepared_statement stmt, idx_t idx,
                               int16_t val);
duckdb_state duckdb_bind_int32(duckdb_prepared_statement stmt, idx_t idx,
                               int32_t val);
duckdb_state duckdb_bind_int64(duckdb_prepared_statement stmt, idx_t idx,
                               int64_t val);
duckdb_state duckdb_bind_uint8(duckdb_prepared_statement stmt, idx_t idx,
                               uint8_t val);
duckdb_state duckdb_bind_uint16(duckdb_prepared_statement stmt, idx_t idx,
                                uint16_t val);
duckdb_state duckdb_bind_uint32(duckdb_prepared_statement stmt, idx_t idx,
                                uint32_t val);
duckdb_state duckdb_bind_uint64(duckdb_prepared_statement stmt, idx_t idx,
                                uint64_t val);
duckdb_state duckdb_bind_float(duckdb_prepared_statement stmt, idx_t idx,
                               float val);
duckdb_state duckdb_bind_double(duckdb_prepared_statement stmt, idx_t idx,
                                double val);
duckdb_state duckdb_bind_hugeint(duckdb_prepared_statement stmt, idx_t idx,
                                 duckdb_hugeint val);
duckdb_state duckdb_bind_date(duckdb_prepared_statement stmt, idx_t idx,
                              duckdb_date val);
duckdb_state duckdb_bind_time(duckdb_prepared_statement stmt, idx_t idx,
                              duckdb_time val);
duckdb_state duckdb_bind_timestamp(duckdb_prepared_statement stmt, idx_t idx,
                                   duckdb_timestamp val);
duckdb_state duckdb_bind_interval(duckdb_prepared_statement stmt, idx_t idx,
                                  duckdb_interval val);
duckdb_state duckdb_bind_varchar(duckdb_prepared_statement stmt, idx_t idx,
                                 const char *val);
duckdb_state duckdb_bind_varchar_length(duckdb_prepared_statement stmt,
                                        idx_t idx, const char *val,
                                        idx_t length);
duckdb_state duckdb_bind_blob(duckdb_prepared_statement stmt, idx_t idx,
                              const void *data, idx_t length);
duckdb_state duckdb_bind_null(duckdb_prepared_statement stmt, idx_t idx);
duckdb_state duckdb_execute_prepared(duckdb_prepared_statement stmt,
                                     duckdb_result *out_result);

/* -- appender ---------------------------------------------------------------- */
duckdb_state duckdb_appender_create(duckdb_connection connection,
                                    const char *schema, const char *table,
                                    duckdb_appender *out);
const char *duckdb_appender_error(duckdb_appender appender);
duckdb_state duckdb_append_bool(duckdb_appender appender, bool value);
duckdb_state duckdb_append_int8(duckdb_appender appender, int8_t value);
duckdb_state duckdb_append_int16(duckdb_appender appender, int16_t value);
duckdb_state duckdb_append_int32(duckdb_appender appender, int32_t value);
duckdb_state duckdb_append_int64(duckdb_appender appender, int64_t value);
duckdb_state duckdb_append_uint8(duckdb_appender appender, uint8_t value);
duckdb_state duckdb_append_uint16(duckdb_appender appender, uint16_t value);
duckdb_state duckdb_append_uint32(duckdb_appender appender, uint32_t value);
duckdb_state duckdb_append_uint64(duckdb_appender appender, uint64_t value);
duckdb_state duckdb_append_float(duckdb_appender appender, float value);
duckdb_state duckdb_append_double(duckdb_appender appender, double value);
duckdb_state duckdb_append_hugeint(duckdb_appender appender,
                                   duckdb_hugeint value);
duckdb_state duckdb_append_date(duckdb_appender appender, duckdb_date value);
duckdb_state duckdb_append_time(duckdb_appender appender, duckdb_time value);
duckdb_state duckdb_append_timestamp(duckdb_appender appender,
                                     duckdb_timestamp value);
duckdb_state duckdb_append_interval(duckdb_appender appender,
                                    duckdb_interval value);
duckdb_state duckdb_append_varchar(duckdb_appender appender, const char *val);
duckdb_state duckdb_append_varchar_length(duckdb_appender appender,
                                          const char *val, idx_t length);
duckdb_state duckdb_append_blob(duckdb_appender appender, const void *data,
                                idx_t length);
duckdb_state duckdb_append_null(duckdb_appender appender);
duckdb_state duckdb_append_value(duckdb_appender appender, duckdb_value value);
duckdb_state duckdb_appender_end_row(duckdb_appender appender);
duckdb_state duckdb_appender_flush(duckdb_appender appender);
duckdb_state duckdb_appender_close(duckdb_appender appender);
duckdb_state duckdb_appender_destroy(duckdb_appender *appender);
idx_t duckdb_appender_column_count(duckdb_appender appender);

/* not DuckDB's: the vector handles alive (each chunk owns its own, made
 * at a column's first duckdb_data_chunk_get_vector), a test hook */
long duckdb_tpu_torch_live_vectors(void);

#ifdef __cplusplus
}
#endif
#endif /* DUCKDB_TPU_TORCH_C_H */
