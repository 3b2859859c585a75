"""The port's C API (duckdb_tpu_torch/capi/: capi.cpp, duckdb_tpu_torch.h,
bridge.py) through ctypes, on the CPU: the counterparts of the seven cases
of tests/test_capi.py.

The library is built here with the host compiler
(duckdb_tpu_torch.capi.library(), into build/torch_kernels/) and loaded
into this process, where it calls the running interpreter, as a C program
would call it. A database opens on CUDA unless its config names a device,
so each case opens with duckdb_open_ext and the config entry device=cpu;
without it, on a host with no card, duckdb_connect fails. Rows are held to
the JAX package's Python API (never its C library, so that two embedding
libraries never share a process).
"""

import ctypes as C

import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch.capi

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib():
    lib = duckdb_tpu_torch.capi.library()
    V, U = C.c_void_p, C.c_uint64
    lib.duckdb_open.argtypes = [C.c_char_p, C.POINTER(V)]
    lib.duckdb_connect.argtypes = [V, C.POINTER(V)]
    lib.duckdb_query.argtypes = [V, C.c_char_p, V]
    for f, res in [("duckdb_column_count", U), ("duckdb_row_count", U)]:
        getattr(lib, f).argtypes = [V]
        getattr(lib, f).restype = res
    for f, res in [("duckdb_column_name", C.c_char_p),
                   ("duckdb_column_type", C.c_int)]:
        getattr(lib, f).argtypes = [V, U]
        getattr(lib, f).restype = res
    for f, res in [("duckdb_value_int64", C.c_int64),
                   ("duckdb_value_double", C.c_double),
                   ("duckdb_value_varchar", V),
                   ("duckdb_value_is_null", C.c_bool),
                   ("duckdb_value_boolean", C.c_bool)]:
        getattr(lib, f).argtypes = [V, U, U]
        getattr(lib, f).restype = res
    lib.duckdb_free.argtypes = [V]
    lib.duckdb_result_error.argtypes = [V]
    lib.duckdb_result_error.restype = C.c_char_p
    lib.duckdb_library_version.restype = C.c_char_p
    lib.duckdb_prepare.argtypes = [V, C.c_char_p, C.POINTER(V)]
    lib.duckdb_bind_int64.argtypes = [V, U, C.c_int64]
    lib.duckdb_bind_double.argtypes = [V, U, C.c_double]
    lib.duckdb_bind_varchar.argtypes = [V, U, C.c_char_p]
    lib.duckdb_bind_null.argtypes = [V, U]
    lib.duckdb_execute_prepared.argtypes = [V, V]
    lib.duckdb_appender_create.argtypes = [V, C.c_char_p, C.c_char_p,
                                           C.POINTER(V)]
    lib.duckdb_append_int64.argtypes = [V, C.c_int64]
    lib.duckdb_append_double.argtypes = [V, C.c_double]
    lib.duckdb_append_varchar.argtypes = [V, C.c_char_p]
    lib.duckdb_append_null.argtypes = [V]
    lib.duckdb_appender_end_row.argtypes = [V]
    lib.duckdb_appender_destroy.argtypes = [C.POINTER(V)]
    return lib


class Result(C.Structure):
    _fields_ = [("internal_data", C.c_void_p)]


class Date(C.Structure):
    _fields_ = [("days", C.c_int32)]


class Time(C.Structure):
    _fields_ = [("micros", C.c_int64)]


class Timestamp(C.Structure):
    _fields_ = [("micros", C.c_int64)]


class Interval(C.Structure):
    _fields_ = [("months", C.c_int32), ("days", C.c_int32),
                ("micros", C.c_int64)]


class Hugeint(C.Structure):
    _fields_ = [("lower", C.c_uint64), ("upper", C.c_int64)]


class Decimal(C.Structure):
    _fields_ = [("width", C.c_uint8), ("scale", C.c_uint8),
                ("value", Hugeint)]


class DateStruct(C.Structure):
    _fields_ = [("year", C.c_int32), ("month", C.c_int8),
                ("day", C.c_int8)]


@pytest.fixture(scope="module")
def lib2(lib):
    V, U = C.c_void_p, C.c_uint64
    for f, res in [("duckdb_value_int32", C.c_int32),
                   ("duckdb_value_int16", C.c_int16),
                   ("duckdb_value_int8", C.c_int8),
                   ("duckdb_value_uint64", C.c_uint64),
                   ("duckdb_value_float", C.c_float)]:
        getattr(lib, f).argtypes = [V, U, U]
        getattr(lib, f).restype = res
    lib.duckdb_value_date.argtypes = [V, U, U]
    lib.duckdb_value_date.restype = Date
    lib.duckdb_value_time.argtypes = [V, U, U]
    lib.duckdb_value_time.restype = Time
    lib.duckdb_value_timestamp.argtypes = [V, U, U]
    lib.duckdb_value_timestamp.restype = Timestamp
    lib.duckdb_value_interval.argtypes = [V, U, U]
    lib.duckdb_value_interval.restype = Interval
    lib.duckdb_value_hugeint.argtypes = [V, U, U]
    lib.duckdb_value_hugeint.restype = Hugeint
    lib.duckdb_value_decimal.argtypes = [V, U, U]
    lib.duckdb_value_decimal.restype = Decimal
    lib.duckdb_from_date.argtypes = [Date]
    lib.duckdb_from_date.restype = DateStruct
    lib.duckdb_to_date.argtypes = [DateStruct]
    lib.duckdb_to_date.restype = Date
    lib.duckdb_hugeint_to_double.argtypes = [Hugeint]
    lib.duckdb_hugeint_to_double.restype = C.c_double
    lib.duckdb_decimal_to_double.argtypes = [Decimal]
    lib.duckdb_decimal_to_double.restype = C.c_double
    lib.duckdb_rows_changed.argtypes = [V]
    lib.duckdb_rows_changed.restype = U
    # chunks take duckdb_result BY VALUE (reference duckdb.h signature)
    lib.duckdb_result_chunk_count.argtypes = [Result]
    lib.duckdb_result_chunk_count.restype = U
    lib.duckdb_result_get_chunk.argtypes = [Result, U]
    lib.duckdb_result_get_chunk.restype = V
    lib.duckdb_data_chunk_get_size.argtypes = [V]
    lib.duckdb_data_chunk_get_size.restype = U
    lib.duckdb_data_chunk_get_column_count.argtypes = [V]
    lib.duckdb_data_chunk_get_column_count.restype = U
    lib.duckdb_data_chunk_get_vector.argtypes = [V, U]
    lib.duckdb_data_chunk_get_vector.restype = V
    lib.duckdb_vector_get_data.argtypes = [V]
    lib.duckdb_vector_get_data.restype = V
    lib.duckdb_vector_get_validity.argtypes = [V]
    lib.duckdb_vector_get_validity.restype = C.POINTER(C.c_uint64)
    lib.duckdb_validity_row_is_valid.argtypes = [C.POINTER(C.c_uint64), U]
    lib.duckdb_validity_row_is_valid.restype = C.c_bool
    lib.duckdb_destroy_data_chunk.argtypes = [C.POINTER(V)]
    lib.duckdb_vector_get_column_type.argtypes = [V]
    lib.duckdb_vector_get_column_type.restype = V
    lib.duckdb_get_type_id.argtypes = [V]
    lib.duckdb_get_type_id.restype = C.c_int
    lib.duckdb_create_decimal_type.argtypes = [C.c_uint8, C.c_uint8]
    lib.duckdb_create_decimal_type.restype = V
    lib.duckdb_decimal_width.argtypes = [V]
    lib.duckdb_decimal_width.restype = C.c_uint8
    lib.duckdb_decimal_scale.argtypes = [V]
    lib.duckdb_decimal_scale.restype = C.c_uint8
    lib.duckdb_create_list_type.argtypes = [V]
    lib.duckdb_create_list_type.restype = V
    lib.duckdb_list_type_child_type.argtypes = [V]
    lib.duckdb_list_type_child_type.restype = V
    lib.duckdb_create_logical_type.argtypes = [C.c_int]
    lib.duckdb_create_logical_type.restype = V
    lib.duckdb_destroy_logical_type.argtypes = [C.POINTER(V)]
    lib.duckdb_create_int64.argtypes = [C.c_int64]
    lib.duckdb_create_int64.restype = V
    lib.duckdb_create_varchar.argtypes = [C.c_char_p]
    lib.duckdb_create_varchar.restype = V
    lib.duckdb_get_int64.argtypes = [V]
    lib.duckdb_get_int64.restype = C.c_int64
    lib.duckdb_get_varchar.argtypes = [V]
    lib.duckdb_get_varchar.restype = V
    lib.duckdb_destroy_value.argtypes = [C.POINTER(V)]
    lib.duckdb_bind_value.argtypes = [V, U, V]
    lib.duckdb_nparams.argtypes = [V]
    lib.duckdb_nparams.restype = U
    lib.duckdb_bind_date.argtypes = [V, U, Date]
    lib.duckdb_append_date.argtypes = [V, Date]
    lib.duckdb_append_bool.argtypes = [V, C.c_bool]
    lib.duckdb_append_int32.argtypes = [V, C.c_int32]
    lib.duckdb_create_config.argtypes = [C.POINTER(V)]
    lib.duckdb_set_config.argtypes = [V, C.c_char_p, C.c_char_p]
    lib.duckdb_destroy_config.argtypes = [C.POINTER(V)]
    lib.duckdb_open_ext.argtypes = [C.c_char_p, C.POINTER(V), V,
                                    C.POINTER(C.c_char_p)]
    lib.duckdb_config_count.restype = C.c_size_t
    lib.duckdb_get_config_flag.argtypes = [C.c_size_t,
                                           C.POINTER(C.c_char_p),
                                           C.POINTER(C.c_char_p)]
    return lib


def _varchar(lib, res, col, row):
    p = lib.duckdb_value_varchar(C.byref(res), col, row)
    if not p:
        return None
    s = C.cast(p, C.c_char_p).value.decode()
    lib.duckdb_free(p)
    return s


def open_cpu(lib, path=b":memory:", **settings):
    """duckdb_open_ext with the config entry device=cpu (and `settings`),
    then duckdb_connect → (database, connection)."""
    lib.duckdb_create_config.argtypes = [C.POINTER(C.c_void_p)]
    lib.duckdb_set_config.argtypes = [C.c_void_p, C.c_char_p, C.c_char_p]
    lib.duckdb_destroy_config.argtypes = [C.POINTER(C.c_void_p)]
    lib.duckdb_open_ext.argtypes = [C.c_char_p, C.POINTER(C.c_void_p), C.c_void_p,
                                    C.POINTER(C.c_char_p)]
    cfg, db, con = C.c_void_p(), C.c_void_p(), C.c_void_p()
    lib.duckdb_create_config(C.byref(cfg))
    for k, v in {"device": "cpu", **settings}.items():
        assert lib.duckdb_set_config(cfg, k.encode(), v.encode()) == 0
    err = C.c_char_p()
    assert lib.duckdb_open_ext(path, C.byref(db), cfg, C.byref(err)) == 0
    lib.duckdb_destroy_config(C.byref(cfg))
    assert lib.duckdb_connect(db, C.byref(con)) == 0
    return db, con


def close(lib, db, con):
    lib.duckdb_disconnect(C.byref(con))
    lib.duckdb_close(C.byref(db))


def jax_rows(*sqls):
    """The JAX package's rows of the last statement."""
    jcon = duckdb_tpu.connect()
    for s in sqls:
        res = jcon.sql(s)
    return res.rows()


def test_capi_lifecycle(lib):
    db, con = open_cpu(lib)
    assert lib.duckdb_library_version() == b"duckdb_tpu_torch 0.1.0"

    res = Result()
    setup = [b"CREATE TABLE t (a INT, s VARCHAR)", b"INSERT INTO t VALUES (1,'x'),(2,NULL),(3,'z')"]
    for s in setup:
        assert lib.duckdb_query(con, s, C.byref(res)) == 0
        lib.duckdb_destroy_result(C.byref(res))
    sql = b"SELECT a, s, a * 2.5 AS d FROM t ORDER BY a"
    assert lib.duckdb_query(con, sql, C.byref(res)) == 0
    assert lib.duckdb_column_count(C.byref(res)) == 3
    assert lib.duckdb_row_count(C.byref(res)) == 3
    assert lib.duckdb_column_name(C.byref(res), 0) == b"a"
    want = jax_rows(*[s.decode() for s in setup], sql.decode())
    got = [(lib.duckdb_value_int64(C.byref(res), 0, r), _varchar(lib, res, 1, r),
            lib.duckdb_value_double(C.byref(res), 2, r)) for r in range(3)]
    assert [(a, s, float(d)) for a, s, d in want] == got
    assert lib.duckdb_value_is_null(C.byref(res), 1, 1)
    lib.duckdb_destroy_result(C.byref(res))

    # error propagation
    assert lib.duckdb_query(con, b"SELECT * FROM missing_table", C.byref(res)) == 1
    err = lib.duckdb_result_error(C.byref(res))
    assert err and b"missing_table" in err
    lib.duckdb_destroy_result(C.byref(res))
    close(lib, db, con)


def test_capi_connects_on_cuda_unless_asked(lib):
    """Without a device entry the connection opens on CUDA: on a host with
    no card duckdb_connect fails (the port raises, naming device="cpu")."""
    db, con = C.c_void_p(), C.c_void_p()
    assert lib.duckdb_open(b":memory:", C.byref(db)) == 0
    rc = lib.duckdb_connect(db, C.byref(con))
    assert rc == (0 if torch.cuda.is_available() else 1)
    if rc == 0:
        lib.duckdb_disconnect(C.byref(con))
    lib.duckdb_close(C.byref(db))


def test_capi_prepared(lib):
    db, con = open_cpu(lib)
    res = Result()
    lib.duckdb_query(con, b"CREATE TABLE p (a INT, b VARCHAR)", C.byref(res))
    lib.duckdb_destroy_result(C.byref(res))
    stmt = C.c_void_p()
    assert lib.duckdb_prepare(con, b"INSERT INTO p VALUES (?, ?)", C.byref(stmt)) == 0
    assert lib.duckdb_bind_int64(stmt, 1, 42) == 0
    assert lib.duckdb_bind_varchar(stmt, 2, b"hello") == 0
    assert lib.duckdb_execute_prepared(stmt, C.byref(res)) == 0
    lib.duckdb_destroy_result(C.byref(res))
    lib.duckdb_destroy_prepare(C.byref(stmt))

    lib.duckdb_query(con, b"SELECT b FROM p WHERE a = 42", C.byref(res))
    assert [(_varchar(lib, res, 0, 0),)] == jax_rows(
        "CREATE TABLE p (a INT, b VARCHAR)", "INSERT INTO p VALUES (42, 'hello')",
        "SELECT b FROM p WHERE a = 42")
    lib.duckdb_destroy_result(C.byref(res))
    close(lib, db, con)


def test_capi_appender(lib):
    db, con = open_cpu(lib)
    res = Result()
    lib.duckdb_query(con, b"CREATE TABLE ap (i BIGINT, x DOUBLE, s VARCHAR)", C.byref(res))
    lib.duckdb_destroy_result(C.byref(res))
    app = C.c_void_p()
    assert lib.duckdb_appender_create(con, None, b"ap", C.byref(app)) == 0
    rows = []
    for i in range(100):
        lib.duckdb_append_int64(app, i)
        lib.duckdb_append_double(app, i * 0.5)
        if i % 10 == 0:
            lib.duckdb_append_null(app)
            rows.append(f"({i}, {i * 0.5}, NULL)")
        else:
            lib.duckdb_append_varchar(app, f"s{i}".encode())
            rows.append(f"({i}, {i * 0.5}, 's{i}')")
        assert lib.duckdb_appender_end_row(app) == 0
    assert lib.duckdb_appender_destroy(C.byref(app)) == 0
    sql = "SELECT count(*), sum(i), count(s) FROM ap"
    lib.duckdb_query(con, sql.encode(), C.byref(res))
    got = tuple(lib.duckdb_value_int64(C.byref(res), c, 0) for c in range(3))
    assert [got] == jax_rows("CREATE TABLE ap (i BIGINT, x DOUBLE, s VARCHAR)",
                             "INSERT INTO ap VALUES " + ", ".join(rows), sql)
    assert got == (100, 4950, 90)
    lib.duckdb_destroy_result(C.byref(res))
    close(lib, db, con)


def test_capi_typed_accessors(lib2):
    lib = lib2
    db, con = open_cpu(lib)
    res = Result()
    lib.duckdb_query(
        con,
        b"SELECT 42::INT, DATE '2024-03-15', TIME '13:45:30',"
        b" TIMESTAMP '2024-03-15 13:45:30', 12.75::DECIMAL(10,2),"
        b" INTERVAL '2 months 3 days'",
        C.byref(res))
    assert lib.duckdb_value_int32(C.byref(res), 0, 0) == 42
    d = lib.duckdb_value_date(C.byref(res), 1, 0)
    ds = lib.duckdb_from_date(d)
    assert (ds.year, ds.month, ds.day) == (2024, 3, 15)
    assert lib.duckdb_to_date(ds).days == d.days
    t = lib.duckdb_value_time(C.byref(res), 2, 0)
    assert t.micros == (13 * 3600 + 45 * 60 + 30) * 1_000_000
    ts = lib.duckdb_value_timestamp(C.byref(res), 3, 0)
    assert ts.micros == d.days * 86_400_000_000 + t.micros
    dec = lib.duckdb_value_decimal(C.byref(res), 4, 0)
    assert dec.scale == 2 and dec.value.lower == 1275
    assert abs(lib.duckdb_decimal_to_double(dec) - 12.75) < 1e-9
    # the port's intervals are microseconds: months normalize to 30 days
    iv = lib.duckdb_value_interval(C.byref(res), 5, 0)
    assert (iv.months, iv.days, iv.micros) == (0, 63, 0)
    lib.duckdb_destroy_result(C.byref(res))

    sql = "SELECT sum(x) FROM (VALUES (9223372036854775807), (9223372036854775807)) t(x)"
    lib.duckdb_query(con, sql.encode(), C.byref(res))
    h = lib.duckdb_value_hugeint(C.byref(res), 0, 0)
    assert [((h.upper << 64) | h.lower,)] == jax_rows(sql) == [(18446744073709551614,)]
    lib.duckdb_destroy_result(C.byref(res))
    close(lib, db, con)


def test_capi_chunks_and_vectors(lib2):
    lib = lib2
    db, con = open_cpu(lib)
    res = Result()
    lib.duckdb_query(
        con,
        b"SELECT range::INT AS i, CASE WHEN range % 100 = 0 THEN NULL"
        b" ELSE 'row-' || range END AS s FROM range(5000)",
        C.byref(res))
    assert lib.duckdb_result_chunk_count(res) == 3  # ceil(5000/2048)
    ch = lib.duckdb_result_get_chunk(res, 1)
    assert lib.duckdb_data_chunk_get_size(ch) == 2048
    assert lib.duckdb_data_chunk_get_column_count(ch) == 2
    vec = lib.duckdb_data_chunk_get_vector(ch, 0)
    ty = lib.duckdb_vector_get_column_type(vec)
    assert lib.duckdb_get_type_id(ty) == 4  # DUCKDB_TYPE_INTEGER
    lib.duckdb_destroy_logical_type(C.byref(C.c_void_p(ty)))
    data = C.cast(lib.duckdb_vector_get_data(vec), C.POINTER(C.c_int32))
    assert data[0] == 2048 and data[2047] == 4095
    svec = lib.duckdb_data_chunk_get_vector(ch, 1)
    validity = lib.duckdb_vector_get_validity(svec)
    # row 2100 (global) = index 52 in chunk 1 → 2100 % 100 == 0 → NULL
    assert not lib.duckdb_validity_row_is_valid(validity, 52)
    assert lib.duckdb_validity_row_is_valid(validity, 53)
    lib.duckdb_destroy_data_chunk(C.byref(C.c_void_p(ch)))
    lib.duckdb_destroy_result(C.byref(res))
    close(lib, db, con)


def test_capi_logical_types_values_config(lib2):
    lib = lib2
    dec = C.c_void_p(lib.duckdb_create_decimal_type(12, 3))
    assert lib.duckdb_decimal_width(dec) == 12
    assert lib.duckdb_decimal_scale(dec) == 3
    lst = C.c_void_p(lib.duckdb_create_list_type(dec))
    child = C.c_void_p(lib.duckdb_list_type_child_type(lst))
    assert lib.duckdb_get_type_id(child) == 19  # DECIMAL
    for t in (dec, lst, child):
        lib.duckdb_destroy_logical_type(C.byref(t))

    v = C.c_void_p(lib.duckdb_create_int64(777))
    assert lib.duckdb_get_int64(v) == 777
    lib.duckdb_destroy_value(C.byref(v))
    v = C.c_void_p(lib.duckdb_create_varchar(b"hi"))
    p = lib.duckdb_get_varchar(v)
    assert C.cast(p, C.c_char_p).value == b"hi"
    lib.duckdb_free(p)
    lib.duckdb_destroy_value(C.byref(v))

    assert lib.duckdb_config_count() >= 10
    names = []
    for k in range(lib.duckdb_config_count()):
        name, desc = C.c_char_p(), C.c_char_p()
        assert lib.duckdb_get_config_flag(k, C.byref(name), C.byref(desc)) == 0
        assert name.value and desc.value
        names.append(name.value)
    assert b"device" in names

    # open_ext applies config entries as settings on connect
    db, con = open_cpu(lib, join_order="greedy")
    res = Result()
    lib.duckdb_query(con, b"SELECT value FROM duckdb_settings() WHERE name = 'join_order'",
                     C.byref(res))
    assert _varchar(lib, res, 0, 0) == "greedy"
    lib.duckdb_destroy_result(C.byref(res))
    close(lib, db, con)


def test_capi_rows_changed_and_typed_append(lib2):
    lib = lib2
    db, con = open_cpu(lib)
    res = Result()
    lib.duckdb_query(con, b"CREATE TABLE r5 (b BOOLEAN, i INT, d DATE)", C.byref(res))
    lib.duckdb_destroy_result(C.byref(res))
    lib.duckdb_query(con, b"INSERT INTO r5 VALUES (true, 1, DATE '2020-01-01'), (false, 2, NULL)",
                     C.byref(res))
    assert lib.duckdb_rows_changed(C.byref(res)) == 2
    lib.duckdb_destroy_result(C.byref(res))

    app = C.c_void_p()
    lib.duckdb_appender_create(con, None, b"r5", C.byref(app))
    lib.duckdb_append_bool(app, True)
    lib.duckdb_append_int32(app, 7)
    lib.duckdb_append_date(app, Date(days=19_000))
    assert lib.duckdb_appender_end_row(app) == 0
    lib.duckdb_appender_destroy(C.byref(app))
    lib.duckdb_query(con, b"SELECT i, d FROM r5 WHERE i = 7", C.byref(res))
    d = lib.duckdb_value_date(C.byref(res), 1, 0)
    assert d.days == 19_000
    lib.duckdb_destroy_result(C.byref(res))

    # prepared: nparams + bind_value + bind_date
    stmt = C.c_void_p()
    lib.duckdb_prepare(con, b"SELECT ? + 1, 'q?'", C.byref(stmt))
    assert lib.duckdb_nparams(stmt) == 1  # the '?' in the string is data
    v = C.c_void_p(lib.duckdb_create_int64(41))
    assert lib.duckdb_bind_value(stmt, 1, v) == 0
    lib.duckdb_destroy_value(C.byref(v))
    assert lib.duckdb_execute_prepared(stmt, C.byref(res)) == 0
    assert [(lib.duckdb_value_int64(C.byref(res), 0, 0), _varchar(lib, res, 1, 0))] == \
        jax_rows("SELECT 41 + 1, 'q?'")
    lib.duckdb_destroy_result(C.byref(res))
    lib.duckdb_destroy_prepare(C.byref(stmt))
    close(lib, db, con)


def test_capi_file_database_reopens(lib, tmp_path):
    """A file database written through the C API is there after
    duckdb_disconnect (the last close checkpoints) for a second open."""
    path = str(tmp_path / "cdb").encode()
    db, con = open_cpu(lib, path)
    res = Result()
    for s in (b"CREATE TABLE f (a INTEGER)", b"INSERT INTO f SELECT range FROM range(10)"):
        assert lib.duckdb_query(con, s, C.byref(res)) == 0
        lib.duckdb_destroy_result(C.byref(res))
    close(lib, db, con)
    db, con = open_cpu(lib, path)
    lib.duckdb_query(con, b"SELECT sum(a) FROM f", C.byref(res))
    assert lib.duckdb_value_int64(C.byref(res), 0, 0) == 45
    lib.duckdb_destroy_result(C.byref(res))
    close(lib, db, con)


# -- C1-C5: the C API faults copied from the JAX package's capi.cpp, held to
# DuckDB's C API (ROADMAP Queue 3)
def _c_faults_lib(lib):
    V = C.c_void_p
    lib.duckdb_create_uint64.argtypes = [C.c_uint64]
    lib.duckdb_create_uint64.restype = V
    lib.duckdb_create_hugeint.argtypes = [Hugeint]
    lib.duckdb_create_hugeint.restype = V
    lib.duckdb_append_value.argtypes = [V, V]
    lib.duckdb_column_logical_type.argtypes = [V, C.c_uint64]
    lib.duckdb_column_logical_type.restype = V
    lib.duckdb_tpu_torch_live_vectors.restype = C.c_long
    return lib


def test_c1_append_value_takes_a_ubigint(lib2):
    """duckdb_append_value of a duckdb_create_uint64 value appends it (it
    appended 0: the value sets only its unsigned field)."""
    lib = _c_faults_lib(lib2)
    db, con = open_cpu(lib)
    res = Result()
    lib.duckdb_query(con, b"CREATE TABLE u (x BIGINT)", C.byref(res))
    lib.duckdb_destroy_result(C.byref(res))
    app = C.c_void_p()
    lib.duckdb_appender_create(con, None, b"u", C.byref(app))
    v = C.c_void_p(lib.duckdb_create_uint64(123_456_789_012))
    assert lib.duckdb_append_value(app, v) == 0
    lib.duckdb_destroy_value(C.byref(v))
    assert lib.duckdb_appender_end_row(app) == 0
    lib.duckdb_appender_destroy(C.byref(app))
    lib.duckdb_query(con, b"SELECT x FROM u", C.byref(res))
    assert lib.duckdb_value_int64(C.byref(res), 0, 0) == 123_456_789_012
    lib.duckdb_destroy_result(C.byref(res))
    close(lib, db, con)


def test_c2_a_chunk_owns_its_vectors(lib2):
    """duckdb_data_chunk_get_vector returns the chunk's own handle: a second
    call allocates nothing, and the chunk frees its handles with it (each
    call leaked a pair and a handle)."""
    lib = _c_faults_lib(lib2)
    db, con = open_cpu(lib)
    res = Result()
    lib.duckdb_query(con, b"SELECT range AS i, range * 2 AS j FROM range(3000)", C.byref(res))
    base = lib.duckdb_tpu_torch_live_vectors()
    ch = lib.duckdb_result_get_chunk(res, 0)
    first = lib.duckdb_data_chunk_get_vector(ch, 0)
    for _ in range(100_000):
        assert lib.duckdb_data_chunk_get_vector(ch, 0) == first
    second = lib.duckdb_data_chunk_get_vector(ch, 1)
    assert second != first
    assert lib.duckdb_tpu_torch_live_vectors() == base + 2
    data = C.cast(lib.duckdb_vector_get_data(second), C.POINTER(C.c_int64))
    assert data[5] == 10
    lib.duckdb_destroy_data_chunk(C.byref(C.c_void_p(ch)))
    assert lib.duckdb_tpu_torch_live_vectors() == base
    lib.duckdb_destroy_result(C.byref(res))
    close(lib, db, con)


def test_c3_decimal_column_reports_its_own_width(lib2):
    """A DECIMAL(10,2) column's logical type is DECIMAL(10,2), not
    DECIMAL(18,2)."""
    lib = _c_faults_lib(lib2)
    db, con = open_cpu(lib)
    res = Result()
    lib.duckdb_query(con, b"SELECT CAST(12.5 AS DECIMAL(10,2)) AS a, "
                          b"CAST(1 AS DECIMAL(4,1)) AS b, CAST(NULL AS DECIMAL(6,3)) AS c",
                     C.byref(res))
    got = []
    for col in range(3):
        t = C.c_void_p(lib.duckdb_column_logical_type(C.byref(res), col))
        got.append((lib.duckdb_decimal_width(t), lib.duckdb_decimal_scale(t)))
        lib.duckdb_destroy_logical_type(C.byref(t))
    assert got == [(10, 2), (4, 1), (6, 3)]
    lib.duckdb_destroy_result(C.byref(res))
    close(lib, db, con)


@pytest.mark.parametrize("make,text", [
    ("hugeint", str(-(1 << 100) - 7)),
    ("hugeint", str((1 << 127) - 1)),
    ("uint64", str((1 << 64) - 1)),
    ("uint64", "5"),
])
def test_c4_get_varchar_prints_wide_values_in_full(lib2, make, text):
    """duckdb_get_varchar of a HUGEINT prints all 128 bits, and of a UBIGINT
    the unsigned value (it printed the low 64 bits, and 0)."""
    lib = _c_faults_lib(lib2)
    n = int(text)
    if make == "hugeint":
        v = C.c_void_p(lib.duckdb_create_hugeint(
            Hugeint(lower=n & ((1 << 64) - 1), upper=n >> 64)))
    else:
        v = C.c_void_p(lib.duckdb_create_uint64(n))
    p = lib.duckdb_get_varchar(v)
    assert C.cast(p, C.c_char_p).value.decode() == text
    lib.duckdb_free(p)
    lib.duckdb_destroy_value(C.byref(v))


@pytest.mark.parametrize("name,value,match", [
    ("no_such_option", "1", "unrecognized configuration parameter"),
    ("join_order", "sideways", "join_order must be one of"),
    ("threads", "many", "takes an integer"),
    ("device", "nowhere", "the device"),
])
def test_c5_open_ext_refuses_a_bad_option(lib2, name, value, match):
    """duckdb_open_ext checks its config at open: a bad option fails the
    open and fills out_error (the open succeeded and the first connect
    failed, with out_error never set)."""
    lib = lib2
    cfg, db = C.c_void_p(), C.c_void_p()
    lib.duckdb_create_config(C.byref(cfg))
    lib.duckdb_set_config(cfg, b"device", b"cpu")
    lib.duckdb_set_config(cfg, name.encode(), value.encode())
    err = C.c_char_p()
    assert lib.duckdb_open_ext(b":memory:", C.byref(db), cfg, C.byref(err)) == 1
    lib.duckdb_destroy_config(C.byref(cfg))
    assert not db.value
    assert err.value is not None and match in err.value.decode()
    lib.duckdb_free(err)
