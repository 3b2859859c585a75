"""Grammar-driven SQL fuzzer (reference analog: test/fuzzer/duckfuzz).

The port's own copy of the JAX package's duckdb_tpu/testing/fuzz.py: the
same grammar and the same random.Random(seed) calls, so that a seed gives
the same SQL text in both packages. Generates random-but-valid-shaped
SELECT statements over a seed schema and executes them. The contract: the
engine may REJECT a query with a typed engine error (the classes of
duckdb_tpu_torch/errors.py, BindError, ParserError, or any ValueError),
but it must never crash, assert, or raise a bare Python error (TypeError,
KeyError, IndexError, AttributeError): those are bugs.

Deterministic per seed. Used by tests/test_torch_fuzz.py (CI-sized runs),
tests/test_torch_fuzz_diff.py (the port against the JAX package),
tools/torch_fuzz.py (long runs) and chip_smoke.py's phase 23 (a card
connection against a CPU connection).
"""

from __future__ import annotations

import math
import random
import re

# typed engine errors: acceptable rejections
ACCEPTABLE = (
    "ParserError", "BindError", "ConversionException", "BinderException",
    "NotImplementedException", "InvalidInputException", "OutOfRangeException",
    "ConnectionException", "CatalogException", "ConstraintException",
    "SyntaxException", "MacroError", "TransactionException",
    "SerializationException", "Error",
)

INT_COLS = ("a", "b", "g")
STR_COLS = ("s",)
FLOAT_COLS = ("f",)
DATE_COLS = ("d",)
ALL_COLS = INT_COLS + STR_COLS + FLOAT_COLS + DATE_COLS

SETUP = [
    "CREATE TABLE t1 (a INTEGER, b BIGINT, g INTEGER, s VARCHAR, "
    "f DOUBLE, d DATE)",
    "INSERT INTO t1 SELECT range, range * 1000000007 % 97, range % 5, "
    "'v' || (range % 13), range / 7.0, "
    "DATE '2020-01-01' + INTERVAL (range % 900) DAYS FROM range(500)",
    "INSERT INTO t1 VALUES (NULL, NULL, NULL, NULL, NULL, NULL)",
    "CREATE TABLE t2 (a INTEGER, x VARCHAR, y DOUBLE)",
    "INSERT INTO t2 SELECT range * 2, 'k' || (range % 7), range * 1.5 "
    "FROM range(200)",
]

AGGS = ("sum", "min", "max", "avg", "count", "first", "stddev",
        "bool_and", "string_agg", "median", "product", "bit_xor",
        "approx_count_distinct", "arg_min", "var_pop", "entropy")
SCALAR_FNS = ("abs", "length", "upper", "lower", "round", "floor", "sqrt",
              "ln", "reverse", "trim", "md5", "year", "hash", "ascii",
              "sign", "bit_count", "least", "greatest", "coalesce",
              "concat", "left", "right", "repeat", "instr", "strip_accents",
              "damerau_levenshtein", "to_base", "format_bytes", "even",
              "gamma", "cot", "atan2", "list_value", "nullif")
BINOPS = ("+", "-", "*", "/", "%", "//", "||")
CMPS = ("=", "<>", "<", "<=", ">", ">=")


class SqlFuzzer:
    def __init__(self, seed: int):
        self.rng = random.Random(seed)

    def expr(self, depth: int = 0) -> str:
        r = self.rng
        if depth > 3 or r.random() < 0.3:
            return r.choice([
                r.choice(ALL_COLS),
                str(r.randint(-5, 100)),
                f"{r.uniform(-2, 2):.3f}",
                f"'{r.choice(['x', 'v1', 'k3', '', 'zz', '%1%'])}'",
                "NULL",
                "DATE '2020-06-15'",
                str(2 ** 63 - r.randint(0, 2)),
            ])
        kind = r.randint(0, 6)
        if kind == 0:
            return (f"({self.expr(depth + 1)} {r.choice(BINOPS)} "
                    f"{self.expr(depth + 1)})")
        if kind == 1:
            fn = r.choice(SCALAR_FNS)
            nargs = r.randint(1, 2)
            args = ", ".join(self.expr(depth + 1) for _ in range(nargs))
            return f"{fn}({args})"
        if kind == 2:
            return (f"CASE WHEN {self.pred(depth + 1)} THEN "
                    f"{self.expr(depth + 1)} ELSE {self.expr(depth + 1)} END")
        if kind == 3:
            t = r.choice(["INTEGER", "BIGINT", "VARCHAR", "DOUBLE",
                          "DECIMAL(12,3)", "DATE", "HUGEINT"])
            return f"TRY_CAST({self.expr(depth + 1)} AS {t})"
        if kind == 4:
            return f"(SELECT {r.choice(['min(a)', 'max(b)', 'count(*)'])} FROM t2)"
        if kind == 5:
            return f"({self.expr(depth + 1)})"
        return (f"CASE {self.expr(depth + 1)} WHEN {self.expr(depth + 1)} "
                f"THEN {self.expr(depth + 1)} END")

    def pred(self, depth: int = 0) -> str:
        r = self.rng
        if depth > 3 or r.random() < 0.4:
            return (f"{self.expr(depth + 1)} {r.choice(CMPS)} "
                    f"{self.expr(depth + 1)}")
        kind = r.randint(0, 5)
        if kind == 0:
            return f"({self.pred(depth + 1)} AND {self.pred(depth + 1)})"
        if kind == 1:
            return f"({self.pred(depth + 1)} OR {self.pred(depth + 1)})"
        if kind == 2:
            return f"NOT ({self.pred(depth + 1)})"
        if kind == 3:
            return f"{self.expr(depth + 1)} IS {r.choice(['NULL', 'NOT NULL'])}"
        if kind == 4:
            items = ", ".join(self.expr(depth + 1)
                              for _ in range(r.randint(1, 3)))
            return f"{self.expr(depth + 1)} IN ({items})"
        return (f"{r.choice(ALL_COLS)} IN (SELECT {r.choice(['a', 'x'])} "
                f"FROM t2)") if r.random() < 0.5 else \
            (f"EXISTS (SELECT 1 FROM t2 WHERE t2.a = t1.{r.choice(INT_COLS)})")

    def query(self) -> str:
        r = self.rng
        shape = r.randint(0, 4)
        if shape == 0:  # plain projection
            sel = ", ".join(self.expr() for _ in range(r.randint(1, 4)))
            q = f"SELECT {sel} FROM t1"
            if r.random() < 0.7:
                q += f" WHERE {self.pred()}"
        elif shape == 1:  # aggregate
            aggs = ", ".join(
                f"{r.choice(AGGS)}({self.expr()})"
                for _ in range(r.randint(1, 3)))
            q = f"SELECT g, {aggs} FROM t1"
            if r.random() < 0.5:
                q += f" WHERE {self.pred()}"
            q += " GROUP BY g"
            if r.random() < 0.3:
                q += f" HAVING {self.pred()}"
        elif shape == 2:  # join
            q = (f"SELECT {self.expr()}, t2.y FROM t1 "
                 f"{r.choice(['JOIN', 'LEFT JOIN', 'SEMI JOIN', 'ANTI JOIN'])} "
                 f"t2 ON t1.a = t2.a")
            if r.random() < 0.5:
                q += f" WHERE {self.pred()}"
        elif shape == 3:  # window
            fn = r.choice(["row_number()", "rank()", "lag(a)",
                           "sum(b)", "avg(f)"])
            q = (f"SELECT a, {fn} OVER (PARTITION BY g ORDER BY "
                 f"{r.choice(ALL_COLS)}) FROM t1")
        else:  # set op / distinct / subquery-from
            inner = f"SELECT {self.expr()} e FROM t1 WHERE {self.pred()}"
            q = (f"SELECT DISTINCT e FROM ({inner}) s"
                 if r.random() < 0.5
                 else f"{inner} UNION ALL {inner}")
        if r.random() < 0.4:
            q += f" ORDER BY 1{' DESC' if r.random() < 0.5 else ''}"
        if r.random() < 0.3:
            q += f" LIMIT {r.randint(0, 20)}"
        return q


def is_typed(e: BaseException) -> bool:
    """Whether an exception is an acceptable rejection: a typed engine
    error of the port (InternalException is not: it is a bug by name)."""
    from duckdb_tpu_torch import errors
    from duckdb_tpu_torch.planner.macros import MacroError

    if isinstance(e, errors.InternalException):
        return False
    return (type(e).__name__ in ACCEPTABLE
            or isinstance(e, (ValueError, errors.Error, errors.ConnectionException,
                              MacroError)))


def setup_connection(con):
    """Run SETUP on a connection → the connection."""
    for stmt in SETUP:
        con.sql(stmt)
    return con


def run_fuzz(n: int, seed: int = 0, con=None, on_fail=None):
    """Run n random queries; returns (n_ok, n_rejected, failures).

    failures = [(sql, exception)] for NON-acceptable errors. Without `con`,
    a new connection on the default device (CUDA: it raises without a
    card) with SETUP run on it."""
    import duckdb_tpu_torch

    if con is None:
        con = setup_connection(duckdb_tpu_torch.connect())
    fz = SqlFuzzer(seed)
    n_ok = n_rej = 0
    failures = []
    for _ in range(n):
        sql = fz.query()
        try:
            con.sql(sql)
            n_ok += 1
        except Exception as e:  # noqa: BLE001 — classifying is the point
            if is_typed(e):
                n_rej += 1
            else:
                failures.append((sql, e))
                if on_fail is not None:
                    on_fail(sql, e)
    return n_ok, n_rej, failures


# -- differential runs -----------------------------------------------------------
_ORDER_TAIL = re.compile(r" ORDER BY 1( DESC)?( LIMIT \d+)?$")
_LIMIT_TAIL = re.compile(r" LIMIT \d+$")
REL_TOL = 1e-9


def run_one(con, sql):
    """("rows", rows) or ("error", exception) of one statement (its rows
    read to the host)."""
    try:
        return "rows", con.sql(sql).rows()
    except Exception as e:  # noqa: BLE001 — the caller classifies
        return "error", e


def _same_value(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if math.isinf(a) or math.isinf(b):
            return a == b
        return abs(a - b) <= REL_TOL * max(abs(a), abs(b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same_value(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_value(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def _sort_key(row):
    """A total order over rows of mixed values: floats rounded so that two
    within REL_TOL usually sort together (pairs are then compared with the
    tolerance)."""
    def k(v):
        if v is None:
            return (0, "")
        if isinstance(v, float):
            return (1, "nan" if math.isnan(v) else f"{v:.6e}")
        return (2, type(v).__name__, repr(v))
    return tuple(k(v) for v in row)


def _same_multiset(a, b) -> bool:
    if len(a) != len(b):
        return False
    return all(len(x) == len(y) and all(_same_value(p, q) for p, q in zip(x, y))
               for x, y in zip(sorted(a, key=_sort_key), sorted(b, key=_sort_key)))


def _runs(rows):
    """Consecutive rows with equal first values (ORDER BY 1's ties)."""
    out = []
    for r in rows:
        if out and _same_value(out[-1][0][0], r[0]):
            out[-1].append(r)
        else:
            out.append([r])
    return out


def rows_differ(sql: str, a, b):
    """Why two answers to one fuzz query differ (None: they agree). DOUBLE
    within REL_TOL relative, everything else exact. Under a top-level
    ORDER BY 1 without LIMIT the rows compare in order, rows that tie on
    the first column as a multiset; with a LIMIT, the row count and the
    first column in order; under a LIMIT without ORDER BY, the row count
    only; else the rows as multisets."""
    if len(a) != len(b):
        return f"row count {len(a)} != {len(b)}"
    m = _ORDER_TAIL.search(sql)
    if m is not None and m.group(2):
        ok = all(_same_value(x[0], y[0]) for x, y in zip(a, b))
        return None if ok else "first column differs under ORDER BY … LIMIT"
    if m is not None:
        ra, rb = _runs(a), _runs(b)
        ok = len(ra) == len(rb) and all(_same_multiset(x, y) for x, y in zip(ra, rb))
        return None if ok else "ordered rows differ"
    if _LIMIT_TAIL.search(sql):
        return None
    return None if _same_multiset(a, b) else "rows differ"


# results larger than this compare column-wise with numpy first: Python
# rows of a million-row result take seconds to build and to sort
FAST_ROWS = 10_000


def run_result(con, sql):
    """("rows", Result) or ("error", exception) of one statement: the
    result's columns are on the host, its Python rows not yet built."""
    try:
        return "rows", con.sql(sql)
    except Exception as e:  # noqa: BLE001 — the caller classifies
        return "error", e


def _column_keys(a, b):
    """Per column, int64 keys of both results' values such that equal keys
    mean equal values (a DOUBLE to about 1e-9 relative), NULL apart; None
    for a column kind this does not encode (the caller compares rows)."""
    import numpy as np

    keys = []
    for (va, ma, da), (vb, mb, db), t in zip(a.columns, b.columns, a.types):
        va, vb = np.asarray(va)[:a.nrows], np.asarray(vb)[:b.nrows]
        if da is not None or db is not None:
            if t.id.name != "VARCHAR":
                return None
            xa = np.asarray(da, dtype=object)[va.astype(np.int64)]
            xb = np.asarray(db, dtype=object)[vb.astype(np.int64)]
            _, inv = np.unique(np.concatenate([xa, xb]).astype(str), return_inverse=True)
            ka, kb = inv[:len(xa)].astype(np.int64), inv[len(xa):].astype(np.int64)
        elif va.dtype.kind == "f":
            def fkey(x):
                x = x.astype(np.float64)
                fin = np.isfinite(x)
                m, e = np.frexp(np.where(fin, x, 0.0))
                # equal keys: within 2^-31 relative, inside REL_TOL
                k = e.astype(np.int64) * (1 << 34) + np.rint(m * (1 << 32)).astype(np.int64)
                k = np.where(np.isnan(x), 1 << 62, k)
                return np.where(np.isinf(x), np.where(x > 0, 1, -1) * ((1 << 62) - 1), k)
            ka, kb = fkey(va), fkey(vb)
        elif va.dtype.kind in "iub" and vb.dtype.kind in "iub":
            ka, kb = va.astype(np.int64), vb.astype(np.int64)
        else:
            return None
        for k, m in ((ka, ma), (kb, mb)):
            if m is not None:
                k[~np.asarray(m)[:len(k)]] = np.iinfo(np.int64).min
        keys.append((ka, kb))
    return keys


def _fast_same(sql, a, b) -> bool:
    """Whether two large results surely agree as rows_differ compares them
    (False: not sure)."""
    import numpy as np

    keys = _column_keys(a, b)
    if keys is None:
        return False
    A = np.stack([ka for ka, _ in keys], 1)
    B = np.stack([kb for _, kb in keys], 1)
    m = _ORDER_TAIL.search(sql)
    if m is not None and m.group(2):
        return bool(np.array_equal(A[:, 0], B[:, 0]))
    if m is None and _LIMIT_TAIL.search(sql):
        return True
    if m is not None:  # ties on the first column compare as multisets
        if not np.array_equal(A[:, 0], B[:, 0]):
            return False
        run = np.cumsum(np.r_[True, A[1:, 0] != A[:-1, 0]])
        A = np.column_stack([run, A])
        B = np.column_stack([run, B])
    sa = A[np.lexsort(A.T[::-1])]
    sb = B[np.lexsort(B.T[::-1])]
    return bool(np.array_equal(sa, sb))


def results_differ(sql: str, a, b):
    """rows_differ over two Results: over FAST_ROWS rows, numpy decides when
    it finds them equal, and the rows are compared only otherwise."""
    if a.nrows != b.nrows:
        return f"row count {a.nrows} != {b.nrows}"
    if a.nrows > FAST_ROWS and _fast_same(sql, a, b):
        return None
    return rows_differ(sql, a.rows(), b.rows())


def card_against_cpu(n: int, seed: int, card_con, cpu_con, after_card=None):
    """The port on two connections (a card's and the CPU's, each with the
    same tables): n queries of `seed` through both → (answered, refused,
    problems, walls). A problem is a non-typed error on either, rows that
    differ (rows_differ), or a query one refuses and the other answers or
    refuses with another class: [(index, sql, what)]. walls: the card
    connection's seconds per query (its columns read to the host);
    after_card(i, sql), if given, runs after each card query's wall is
    taken and may return a problem's text."""
    import time

    fz = SqlFuzzer(seed)
    answered = refused = 0
    problems, walls = [], []
    for i in range(n):
        sql = fz.query()
        t0 = time.perf_counter()
        ka, va = run_result(card_con, sql)
        walls.append(time.perf_counter() - t0)
        if after_card is not None:
            what = after_card(i, sql)
            if what:
                problems.append((i, sql, what))
        kb, vb = run_result(cpu_con, sql)
        for kind, v, where in ((ka, va, "card"), (kb, vb, "cpu")):
            if kind == "error" and not is_typed(v):
                problems.append((i, sql, f"{where}: {type(v).__name__}: {v}"))
        if ka == kb == "rows":
            answered += 1
            why = results_differ(sql, va, vb)
            if why:
                problems.append((i, sql, why))
        elif ka == kb == "error":
            refused += 1
            if type(va) is not type(vb):
                problems.append((i, sql, f"card {type(va).__name__} != cpu {type(vb).__name__}"))
        else:
            problems.append((i, sql, f"card {ka}, cpu {kb}: "
                             f"{va if ka == 'error' else vb}"))
    return answered, refused, problems, walls


def sized_setup(t1_rows: int, t2_rows: int):
    """SETUP's statements with t1 made over range(t1_rows) and t2 over
    range(t2_rows), by the same formulas."""
    out = [stmt.replace("range(500)", f"range({t1_rows})") for stmt in SETUP]
    return [stmt.replace("range(200)", f"range({t2_rows})") for stmt in out]
