"""The functions of planner/functions_parity.py, the array_* aliases and the
names the binder binds structurally, in duckdb_tpu_torch (device="cpu"),
against duckdb_tpu, numpy and DuckDB's answers.

Every family runs through SQL in both packages at SF 0.01, seed 7: the
bitwise operators as functions, the math aliases and bins, glob, the list
vector math, the rest of the lists, structs, maps, the interval
constructors, the generic/meta functions and the array_* alias table;
then struct_insert/struct_update with `:=` and the to_months …
to_millennia constructors. The reference's inner nested values are
tuples (ROADMAP Queue 3, (c)), so rows compare through `_deep`. Over a
columnar list the reference raises (faults (j) and (k)), so those
queries are held to numpy; a repeated map key (fault (l)) and `>>` of a
negative number are held to DuckDB. DOUBLE results within 1e-9 relative,
all else exactly.
"""

import datetime
import math

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.testing import tpch_oracle
from duckdb_tpu_torch.testing.tpch_gen import write_tables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_functions_parity")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


@pytest.fixture(scope="module")
def cons(data_dir):
    jcon = duckdb_tpu.connect()
    jcon.load_tpch(data_dir)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    return jcon, tcon


def _deep(v, top=True):
    """Inner nested values as tuples (the reference's form), the top level kept."""
    if isinstance(v, (list, tuple)):
        inner = [_deep(x, False) for x in v]
        return inner if top and isinstance(v, list) else tuple(inner)
    if isinstance(v, dict):
        return {k: _deep(x, False) for k, x in v.items()} if top \
            else tuple(_deep(x, False) for x in v.values())
    return v


def _rows(con, sql):
    return sorted((tuple(_deep(v) for v in r) for r in con.sql(sql).rows()), key=repr)


def _close(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9, abs=1e-12, nan_ok=True), (g, w)
            else:
                assert a == b, (g, w)


_O = "FROM orders WHERE o_orderkey < 1500"
SQL = {
    "bitwise": "SELECT o_orderkey, o_orderkey & 255, o_orderkey | 7, xor(o_orderkey, o_custkey), "
               "o_orderkey << 2, o_custkey >> 3, ~o_custkey, \"&\"(o_custkey, 15), "
               f"get_bit(o_orderkey, 2), set_bit(o_orderkey, 0, 1) {_O}",
    "bitwise_constants": "SELECT 12 & 10, 12 | 3, xor(12, 10), 1 << 62, 1024 >> 3, ~0, "
                         "7 >> 64, get_bit(5, 0), set_bit(8, 1, 1), bitstring('101', 6)",
    "math_bins": "SELECT greatest_common_divisor(o_orderkey, 12), least_common_multiple("
                 f"o_custkey % 9 + 1, 6) {_O}",
    "bins_constants": "SELECT equi_width_bins(0, 10, 2, false), equi_width_bins(0, 1.0, 4, "
                      "false), equi_width_bins(0, 100, 3, true), format_bytes(0), "
                      "format_bytes(1048576), format_bytes(1024), is_histogram_other_bin(''), "
                      "is_histogram_other_bin('x'), is_histogram_other_bin(3)",
    "glob": "SELECT p_partkey, glob(p_type, 'PROMO*'), p_container ~~~ '?? BOX', "
            "glob(p_name, '*green*') FROM part WHERE p_partkey < 700",
    "vector_constants": "SELECT list_distance([1, 2, 3], [1, 2, 5]), list_dot_product([1, 2], "
                        "[3, 4]), list_inner_product([1.5, 2.0], [2.0, 4.0]), "
                        "list_negative_dot_product([1, 2], [3, 4]), "
                        "list_negative_inner_product([1, 1], [2, 2]), "
                        "list_cosine_similarity([1, 0], [1, 1]), "
                        "list_cosine_distance([1, 2], [2, 4]), array_distance([3, 4], [0, 0]), "
                        "array_dot_product([1, 2], [3, 4]), array_inner_product([1], [9]), "
                        "array_negative_dot_product([2], [3]), "
                        "array_negative_inner_product([2], [4]), "
                        "array_cosine_similarity([1, 2], [2, 1]), "
                        "array_cosine_distance([1, 0], [0, 1]), [1, 2] <-> [4, 6], "
                        "[1, 0] <=> [0, 1], array_cross_product([1, 2, 3], [4, 5, 6])",
    "lists": "SELECT list_has_all([1, 2, 3], [1, 3]), list_has_any([1, 2], [5, 2]), "
             "array_has_all([1], [2]), array_has_any([1], [2]), [1, 2, 3] @> [2], "
             "[2] <@ [1, 2], [1, 2] && [3], list_intersect([1, 2, 3, 2], [2, 3, 4]), "
             "array_intersect([1], [1]), list_select([10, 20, 30], [3, 1, 7]), "
             "array_select(['a', 'b'], [2]), list_where([1, 2, 3], [true, false, true]), "
             "array_where(['x', 'y'], [false, true]), list_zip([1, 2], ['a']), "
             "array_zip([1], [2]), list_resize([1, 2, 3], 2), list_resize([1], 3, 0), "
             "array_resize([1, 2], 4), list_grade_up([3, 1, 2]), grade_up([2, 1]), "
             "array_grade_up([5, 4, 6]), unpivot_list(1, 2)",
    "structs": "SELECT struct_keys({'a': 1, 'b': 2}), struct_values({'a': 1, 'b': 2}), "
               "struct_contains({'a': 1, 'b': 2}, 2), struct_position({'a': 7, 'b': 8}, 8), "
               "struct_indexof({'a': 7}, 9), struct_has({'a': 1}, 'a'), struct_has({'a': 1}, "
               "'z'), struct_extract_at({'a': 1, 'b': 'x'}, 2), "
               "struct_concat({'a': 1}, {'b': 2})",
    "struct_named": "SELECT struct_insert({'a': 1}, b := 2, c := 'x'), "
                    "struct_update({'a': 1, 'b': 2}, b := 3)",
    "maps": "SELECT map_entries(MAP {'k': 1, 'j': 2}), map_from_entries([{'k': 'a', 'v': 1}, "
            "{'k': 'b', 'v': 2}]), map_concat(MAP {'a': 1}, MAP {'b': 2, 'a': 3}), "
            "map_extract_value(MAP {'k': 7}, 'k'), map_extract(MAP {'k': 7}, 'k'), "
            "map_extract(MAP {'k': 7}, 'z')",
    "intervals": "SELECT to_months(3), to_quarters(1), to_years(2), to_decades(1), "
                 "to_centuries(1), to_millennia(1), DATE '2024-01-31' + to_months(1), "
                 "TIMESTAMP '2023-03-31 10:00:00' + to_quarters(1), "
                 "normalized_interval(INTERVAL '1 day')",
    "nanosecond": "SELECT o_orderkey, nanosecond(CAST(o_orderdate AS TIMESTAMP) + "
                  f"to_microseconds(o_orderkey * 7919)) {_O}",
    "meta": "SELECT stats(5), vector_type(o_orderstatus), current_query_id(), "
            "in_search_path('memory', 'main'), in_search_path('memory', 'other'), "
            "path_join(o_orderstatus, 'x', 'y.csv'), getvariable('nothing') "
            "FROM orders WHERE o_orderkey < 40",
    "sort_key": "SELECT o_orderkey, create_sort_key(o_custkey, 'asc nulls last'), "
                "create_sort_key(o_orderstatus, 'desc nulls first', o_orderkey, 'asc nulls last')"
                f" {_O}",
    "array_aliases": "SELECT array_aggr([1, 2, 3], 'sum'), array_aggregate([1, 2], 'max'), "
                     "array_cat([1], [2]), array_distinct([1, 1, 2]), array_has([1, 2], 2), "
                     "array_indexof([5, 6], 6), array_reverse_sort([1, 3, 2]), "
                     "array_sort([3, 1]), array_unique([1, 1, 2]), array_value(1, 2), "
                     "array_slice([1, 2, 3], 2, 3), array_position([7, 8], 8), "
                     "array_reverse([1, 2]), array_append([1], 2), array_prepend(0, [1])",
    "operators": "SELECT \"+\"(1, 2), \"-\"(5, 3), \"-\"(4), \"*\"(2, 3), \"/\"(7, 2), "
                 "\"//\"(7, 2), \"%\"(7, 3), add(1, 2), subtract(5, 1), multiply(2, 4), "
                 "divide(9, 3), \"=\"(1, 1), \"==\"(1, 2), \"!=\"(1, 2), \"<>\"(1, 1), "
                 "\"<\"(1, 2), \"<=\"(2, 2), \">\"(1, 2), \">=\"(3, 2), \"**\"(2, 10), "
                 "\"^\"(2, 3), \"@\"(-4), \"!__postfix\"(5), \"~~\"('abc', 'a%'), "
                 "\"!~~\"('abc', 'a%'), \"~~*\"('ABC', 'a%'), \"!~~*\"('ABC', 'a%'), "
                 "\"~~~\"('abc', 'a*'), \"^@\"('abc', 'ab'), \"||\"('a', 'b'), "
                 "\"__between\"(2, 1, 3)",
}


@pytest.mark.parametrize("name", sorted(SQL))
def test_function_matches_jax(cons, name):
    jcon, tcon = cons
    _close(_rows(tcon, SQL[name]), _rows(jcon, SQL[name]))


# -- over columnar lists: the reference raises (faults (j), (k)), numpy decides --------
_PACK = "(SELECT p_partkey, p_size, list_value(p_size, p_partkey % 7) AS v FROM part) t"


def _part(data_dir):
    t = tpch_oracle._Tables(data_dir)
    return t("part", "p_partkey").astype(np.int64), t("part", "p_size").astype(np.int64)


def test_vector_math_over_a_columnar_list(cons, data_dir):
    _, tcon = cons
    key, size = _part(data_dir)
    a = np.stack([size, key % 7], 1).astype(np.float64)
    b = np.array([1.0, 2.0])
    rows = tcon.sql(f"SELECT p_partkey, list_dot_product(v, [1, 2]), list_distance(v, [10, 3]), "
                    f"list_cosine_similarity(v, [1, 1]), list_negative_inner_product(v, v), "
                    f"v <-> [0, 0] FROM {_PACK}").rows()
    assert len(rows) == len(key)
    order = np.argsort(key)
    for (k, dot, dist, cos, neg, norm), i in zip(sorted(rows), order):
        x = a[i]
        assert k == key[i]
        assert dot == pytest.approx(float(x @ b), rel=1e-9)
        assert dist == pytest.approx(float(np.sqrt(((x - [10, 3]) ** 2).sum())), rel=1e-9)
        assert cos == pytest.approx(float(x.sum() / (np.linalg.norm(x) * math.sqrt(2))),
                                    rel=1e-9)
        assert neg == pytest.approx(float(-(x @ x)), rel=1e-9)
        assert norm == pytest.approx(float(np.linalg.norm(x)), rel=1e-9, abs=1e-12)
    (total,), = tcon.sql(f"SELECT sum(list_dot_product(v, [1, 2])) FROM {_PACK}").rows()
    assert total == pytest.approx(float((a @ b).sum()), rel=1e-9)


def test_list_functions_over_a_columnar_list(cons, data_dir):
    """list_grade_up, list_zip and list_resize over a columnar list (fault
    (k)), and list_zip of three lists, held to Python."""
    _, tcon = cons
    key, size = _part(data_dir)
    rows = tcon.sql(f"SELECT p_partkey, list_grade_up(v), len(list_zip(v, v)), "
                    f"list_resize(v, 3, 0)[3], list_zip(v, [1], v)[2], list_select(v, [2, 1]), "
                    f"list_has_any(v, [0, 50]) FROM {_PACK}").rows()
    by_key = dict(zip(key.tolist(), size.tolist()))
    assert len(rows) == len(key)
    for k, grade, nzip, third, z2, sel, anyz in rows:
        v = [by_key[k], k % 7]
        assert grade == sorted([1, 2], key=lambda i: (v[i - 1], i))
        assert (nzip, third, sel) == (2, 0, [v[1], v[0]])
        assert z2 == {"list_1": v[1], "list_2": None, "list_3": v[1]}
        assert anyz == (0 in v or 50 in v)


def test_dimension_check_reads_only_the_rows(cons):
    """A list of another length that no live row holds raises nothing; one
    that a row holds raises DuckDB's error."""
    _, tcon = cons
    sql = ("SELECT sum(list_dot_product(v, [1, 2])) FROM (SELECT CASE WHEN p_size > 0 "
           "THEN list_value(p_size, 1) ELSE list_value(1, 2, 3) END AS v FROM part) t")
    with pytest.raises(ValueError, match="list dimensions must be equal"):
        tcon.sql(sql.replace("p_size > 0", "p_size > 10")).rows()
    (got,), = tcon.sql(sql).rows()
    assert got is not None
    with pytest.raises(ValueError, match="list dimensions must be equal"):
        tcon.sql("SELECT list_distance([1, 2], [1, 2, 3])").rows()


def test_map_from_entries_repeated_key_raises(cons):
    """(l) DuckDB: 'Map keys must be unique'; the reference keeps the last."""
    _, tcon = cons
    with pytest.raises(ValueError, match="Map keys must be unique"):
        tcon.sql("SELECT map_from_entries([{'k': 'a', 'v': 1}, {'k': 'a', 'v': 2}])").rows()


def test_shift_right_keeps_the_sign(cons):
    """DuckDB's >> on a signed integer shifts the sign in; << and >> past 63
    give 0."""
    _, tcon = cons
    assert tcon.sql("SELECT -8 >> 1, -1 >> 63, -8 >> 64, 1 << 64, xor(-1, 5)").rows() == [
        (-4, -1, 0, 0, -6)]


def test_bit_position_counts_exactly(cons):
    """The lowest set bit's 1-based position, held to Python (the reference
    rounds a float log2 down: bit_position(1, 8) gives 3)."""
    _, tcon = cons
    rows = tcon.sql("SELECT o_orderkey, bit_position(1, o_orderkey), bit_position(1, -o_orderkey)"
                    " FROM orders WHERE o_orderkey < 3000").rows()
    assert rows
    for k, p, q in rows:
        assert p == q == (k & -k).bit_length()
    assert tcon.sql("SELECT bit_position(1, 0), bit_position(1, -9223372036854775808)").rows() \
        == [(0, 64)]


def test_is_distinct_from(cons):
    _, tcon = cons
    assert tcon.sql("SELECT 1 IS DISTINCT FROM NULL, NULL IS DISTINCT FROM NULL, "
                    "1 IS NOT DISTINCT FROM 1, 2 IS DISTINCT FROM 3, "
                    "\"IS DISTINCT FROM\"(NULL, 1)").rows() == [(True, False, True, True, True)]
    rows = tcon.sql("SELECT count(*) FROM orders WHERE nullif(o_orderstatus, 'F') "
                    "IS NOT DISTINCT FROM NULL").rows()
    assert rows == tcon.sql("SELECT count(*) FROM orders WHERE o_orderstatus = 'F'").rows()


def test_month_intervals_stay_months(cons):
    """to_months(3) is 3 months, not 90 days, added to a DATE or TIMESTAMP;
    DuckDB's Python API shows a month as 30 days, so the value prints as
    timedelta(days=90) in both packages."""
    _, tcon = cons
    assert tcon.sql("SELECT DATE '2024-01-31' + to_months(1), DATE '2024-11-30' + "
                    "to_quarters(1), DATE '2000-02-29' + to_years(1), to_months(3)").rows() == [
        (datetime.date(2024, 2, 29), datetime.date(2025, 2, 28), datetime.date(2001, 2, 28),
         datetime.timedelta(days=90))]
    with pytest.raises(ValueError, match="non-constant"):
        tcon.sql("SELECT to_months(o_orderkey) FROM orders")


def _add_months(d: datetime.datetime, k: int) -> datetime.datetime:
    total = d.year * 12 + d.month - 1 + k
    y, m = divmod(total, 12)
    nxt = datetime.date(y + (m == 11), (m + 1) % 12 + 1, 1)
    last = (nxt - datetime.timedelta(days=1)).day
    return d.replace(year=y, month=m + 1, day=min(d.day, last))


def test_month_intervals_over_a_column(cons):
    """A DATE or TIMESTAMP column plus or minus a month interval moves by
    calendar months on the device, the day clamped to the month's end
    (DuckDB's AddOperator), held to Python's calendar; the reference
    refuses a month interval over a column."""
    _, tcon = cons
    rows = tcon.sql("SELECT o_orderdate, o_orderdate + to_months(1), o_orderdate - to_years(1), "
                    "CAST(o_orderdate AS TIMESTAMP) + INTERVAL '13 months 2 days 3 hours', "
                    "to_quarters(1) + o_orderdate FROM orders").rows()
    assert len(rows) > 10_000
    for d, a, b, c, q in rows:
        dt = datetime.datetime(d.year, d.month, d.day)
        assert a == _add_months(dt, 1) and b == _add_months(dt, -12) and q == _add_months(dt, 3)
        assert c == _add_months(dt, 13) + datetime.timedelta(days=2, hours=3)
    assert tcon.sql("SELECT d + to_months(1), d - to_months(1) FROM (SELECT "
                    "make_date(2024, 3, 31) AS d)").rows() == [
        (datetime.datetime(2024, 4, 30), datetime.datetime(2024, 2, 29))]


def test_struct_named_arguments_are_required(cons):
    _, tcon = cons
    with pytest.raises(ValueError, match="named arguments"):
        tcon.sql("SELECT struct_insert({'a': 1}, 2)")
    with pytest.raises(ValueError, match="duplicate struct field"):
        tcon.sql("SELECT struct_insert({'a': 1}, a := 2)")
    with pytest.raises(ValueError, match="unknown fields"):
        tcon.sql("SELECT struct_update({'a': 1}, z := 2)")


def test_sequences_and_variables_wait(cons):
    """setval needs its CREATE SEQUENCE (tests/test_torch_sequences_types.py);
    getvariable gives NULL, as the reference does with no variable set
    (neither package has SET VARIABLE: ROADMAP, "Still refused in both
    packages")."""
    jcon, tcon = cons
    with pytest.raises(ValueError, match='Sequence with name "s" does not exist'):
        tcon.sql("SELECT setval('s', 3)")
    assert tcon.sql("SELECT getvariable('x')").rows() == jcon.sql(
        "SELECT getvariable('x')").rows() == [(None,)]


def test_registry_covers_the_reference(cons):
    """Every name the reference's functions_parity registers, its array_*
    alias table included, is registered in the port."""
    import re

    from duckdb_tpu.planner import functions_parity as JP
    from duckdb_tpu.planner.functions import REGISTRY as JREG
    from duckdb_tpu_torch.planner.functions import REGISTRY as TREG

    src = open(JP.__file__).read()
    names = set(re.findall(r'@register\("([^"]+)"\)', src))
    names |= set(re.findall(r'REGISTRY\["(\w+)"\]', src))
    names |= set(re.findall(r'_(?:mk_bitop|vec_pair|bind_two_list_bool|mk_format_readable)'
                            r'\(\s*"([^"]+)"', src))
    names |= {n.replace("list_", "array_") for n in re.findall(r'_vec_pair\("(\w+)"', src)}
    names |= set(JP._ARRAY_ALIASES) & set(JREG)
    assert len(names) > 80 and names <= set(JREG)
    assert names - set(TREG) == set()
