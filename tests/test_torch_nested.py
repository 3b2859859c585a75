"""Nested values in duckdb_tpu_torch (device="cpu") against duckdb_tpu.

LIST, STRUCT, MAP, ARRAY, UNION and BIT: the constructors, element access
and every function of planner/functions_nested.py, the lambdas (both the
`x -> …` / `(a, x) -> …` and the `lambda x: …` forms), the nested casts in
both directions and the nested default macros, over constants and over the
port's generator's tables at SF 0.01, seed 7. Then the columnar list_value
(ListPack) and UNNEST plan nodes, nested values at every depth in
Result.rows, DuckDB's ordering of nested values, and NESTED_QUERIES'
nested_words and nested_pack against the reference and the numpy oracle.

The reference returns a nested value inside a nested value as a tuple
(ROADMAP Queue 3, fault (c)); parity tests compare both packages' rows
through `_deep`, which turns every inner value into a tuple, and the
fault's own tests hold the port to DuckDB's form. Faults (b), (d), (e),
(f) and (g) each have a repro here, held to DuckDB's answer or to numpy.
"""

import re

import numpy as np
import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.blocks import nested as TN
from duckdb_tpu_torch.planner import functions as TF
from duckdb_tpu_torch.testing import tpch_oracle
from duckdb_tpu_torch.testing.tpch_gen import write_tables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_nested")
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
    """Inner nested values as tuples (the reference's form), the top level
    kept: a list stays a list, a dict a dict."""
    if isinstance(v, (list, tuple)):
        inner = [_deep(x, False) for x in v]
        return inner if top and isinstance(v, list) else tuple(inner)
    if isinstance(v, dict):
        return {k: _deep(x, False) for k, x in v.items()} if top \
            else tuple(_deep(x, False) for x in v.values())
    return v


def _rows(con, sql, ordered=False):
    rows = [tuple(_deep(v) for v in r) for r in con.sql(sql).rows()]
    return rows if ordered else sorted(rows, key=repr)


SCALARS = {
    "list_literals": "SELECT [1, 2, 3], [], ['a', NULL], [[1, 2], [3]], [1.5, 2.5], "
                     "[DATE '1992-01-01']",
    "struct_literals": "SELECT {'a': 1, 'b': 'x'}, {'a': {'b': 2}}, struct_pack(a := 1, b := 'y'), "
                       "row(1, 'x')",
    "map_literals": "SELECT MAP {'k': 1, 'j': 2}, map(['a', 'b'], [1, 2]), map()",
    "element_access": "SELECT [1,2,3][2], [1,2,3][-1], [1,2,3][5], [1,2,3][0], {'a': 1}['a'], "
                      "{'a': 1}.a, MAP {'k': 1}['k'], MAP {'k': 1}['z'], "
                      "element_at(MAP {'k': 7}, 'k'), list_element([4,5], 1), "
                      "array_extract([4,5], 2), struct_extract({'q': 3}, 'q')",
    "contains_position": "SELECT list_contains([1,2], 2), list_has([1,2], 3), "
                         "array_contains(['a'], 'a'), list_position([5,6,7], 7), "
                         "list_indexof([5], 9), array_position([1], 1), "
                         "map_contains(MAP {'a': 1}, 'a'), map_contains(MAP {'a': 1}, 'b')",
    "lengths": "SELECT array_length([1,2,3]), list_length([]), cardinality(MAP {'a': 1, 'b': 2}), "
               "list_unique([1,1,NULL,2]), len([1,2,3]), length([4])",
    "list_transforms": "SELECT list_sort([3,1,NULL,2]), list_reverse_sort([3,1,2]), "
                       "list_distinct([1,1,NULL,2]), list_reverse([1,2,3]), "
                       "array_pop_back([1,2,3]), array_pop_front([1,2,3])",
    "concat_append": "SELECT list_concat([1],[2,3]), list_cat([], [1]), array_concat([1],[2],[3]), "
                     "list_append([1], 2), array_append([1], 3), list_prepend(0, [1]), "
                     "array_prepend(9, [1])",
    "slice_flatten": "SELECT list_slice([1,2,3,4], 2, 3), array_slice([1,2,3], -2, -1), "
                     "[1,2,3,4][2:3], flatten([[1,2],[3]]), flatten([[], [NULL]])",
    "map_keys_values": "SELECT map_keys(MAP {'a': 1, 'b': 2}), map_values(MAP {'a': 1, 'b': 2})",
    "string_split": "SELECT string_split('a b c', ' '), str_split('x,y', ','), "
                    "string_to_array('1-2', '-'), split('a', ' ')",
    "range_series": "SELECT range(4), range(1, 5), range(0, 10, 3), generate_series(3), "
                    "generate_series(1, 4), generate_series(5, 1, -2)",
    "union_array": "SELECT union_value(k := 2), union_tag(union_value(k := 2)), "
                   "union_extract(union_value(k := 2), 'k'), array_value(1, 2, 3)",
    "list_aggregate": "SELECT list_aggregate([1,2,3], 'sum'), list_aggr([1,2,3], 'max'), "
                      "aggregate([1,2,NULL], 'count'), "
                      "list_aggregate(['a','b'], 'string_agg', '|'), "
                      "list_aggregate([1.0, 2.0, 4.0], 'avg'), "
                      "list_aggregate([1,2,3,4], 'median'), "
                      "list_aggregate([true, false], 'bool_and'), list_aggregate([3, 5], 'bit_or')",
    "list_aggregate_stats": "SELECT list_aggregate([1,2,2,3], 'mode'), "
                            "list_aggregate([1,2,3], 'var_samp'), "
                            "list_aggregate([1,2,3], 'stddev_pop'), "
                            "list_aggregate([1,2,3,10], 'skewness'), "
                            "list_aggregate([1,1,2], 'entropy'), "
                            "list_aggregate([1,2,3], 'product'), "
                            "list_aggregate([], 'sum'), list_aggregate([5,6], 'first'), "
                            "list_aggregate([5,6], 'last')",
    "lambdas": "SELECT list_transform([1,2,3], x -> x + 1), list_filter([1,2,3,4], x -> x > 2), "
               "list_transform([1,2], lambda x: x * 10), "
               "list_filter(['a','bb'], lambda s: length(s) > 1), apply([1], x -> x), "
               "array_transform([2], x -> x * x), list_apply([3], x -> -x), "
               "array_apply([1], x -> x), filter([1,2], x -> x = 1), "
               "array_filter([1,2], x -> x = 2)",
    "lambda_index": "SELECT list_transform([10,20], lambda x, i: x + i), "
                    "list_filter([5,6,7], lambda x, i: i > 1)",
    "reduce": "SELECT list_reduce([1,2,3], lambda a, x: a + x), "
              "array_reduce([2,3], lambda a, x: a * x), reduce([5], lambda a, x: a - x), "
              "list_reduce(['a','b','c'], lambda a, x: a || x), "
              "list_reduce([], lambda a, x: a + x)",
    "cast_to_nested": "SELECT CAST('[1, 2, NULL]' AS INTEGER[]), CAST('[a, b]' AS VARCHAR[]), "
                      "CAST('{a: 1}' AS STRUCT(a INTEGER)), CAST([1,2] AS INTEGER[2]), "
                      "CAST('101' AS BIT), CAST('[[1], [2, 3]]' AS INTEGER[][])",
    "try_cast": "SELECT TRY_CAST([1,2,3] AS INTEGER[2]), TRY_CAST('x' AS INTEGER[]), "
                "TRY_CAST('2' AS BIT)",
    "bit_to_varchar": "SELECT CAST(CAST('101' AS BIT) AS VARCHAR)",
    "macros": "SELECT array_push_back([1], 2), array_push_front([1], 0), "
              "array_to_string(['a','b'], '-'), array_reverse([1,2]), "
              "map_contains_value(MAP {'a': 1}, 1), list_sum([1,2,3]), list_max([4,2]), "
              "list_min([4,2]), list_count([1,NULL]), list_avg([1,2]), "
              "list_string_agg(['x','y']), list_bool_or([false, true]), list_product([2,3]), "
              "list_first([7,8]), list_last([7,8])",
    "macros_stats": "SELECT list_var_samp([1,2,3]), list_stddev_pop([1,2,3]), list_bit_xor([1,3]), "
                    "list_median([1,2,3]), list_mode([1,1,2]), list_entropy([1,2]), "
                    "list_any_value([3])",
}


@pytest.mark.parametrize("name", sorted(SCALARS))
def test_scalar_matches_jax(cons, name):
    jcon, tcon = cons
    assert _rows(tcon, SCALARS[name]) == _rows(jcon, SCALARS[name])


COLUMNS = {
    "split_columns": "SELECT p_partkey, string_split(p_name, ' '), string_split(p_name, ' ')[1], "
                     "len(string_split(p_name, ' ')) FROM part WHERE p_partkey < 50",
    "functions_over_columns": "SELECT p_partkey, "
                              "list_contains(string_split(p_name, ' '), 'green'), "
                              "list_sort(string_split(p_name, ' ')), "
                              "list_transform(string_split(p_name, ' '), x -> upper(x)), "
                              "list_filter(string_split(p_name, ' '), x -> x LIKE 'b%') "
                              "FROM part WHERE p_partkey < 30",
    "lambdas_over_lists": "SELECT o_custkey, list_reduce(l, lambda a, x: a + x), "
                          "list_transform(l, lambda x, i: x * i), list_filter(l, x -> x % 3 = 0), "
                          "list_aggregate(l, 'max') FROM (SELECT o_custkey, list(o_orderkey) AS l "
                          "FROM orders WHERE o_custkey < 60 GROUP BY 1)",
    "listpack": "SELECT n_nationkey, list_value(n_nationkey, n_regionkey), "
                "list_value(n_name, n_comment)[1] FROM nation",
    "listpack_derived": "SELECT sum(l[1] + l[2]), count(*) FROM "
                        "(SELECT list_value(o_custkey, o_shippriority) AS l FROM orders)",
    "listpack_post_aggregate": "SELECT p_size, count(*), list_value(p_size, count(*)) FROM part "
                               "GROUP BY 1",
    "unnest": "SELECT unnest(string_split(p_name, ' ')) AS w, p_partkey FROM part "
              "WHERE p_partkey < 20",
    "unnest_constant": "SELECT unnest([1, 2, 3])",
    "unnest_zip": "SELECT unnest(string_split(r_name, 'A')), unnest([1, 2]), r_regionkey "
                  "FROM region",
    "unnest_grouped": "SELECT w, count(*) FROM (SELECT unnest(string_split(p_type, ' ')) AS w "
                      "FROM part) GROUP BY w",
    "distinct_list_element": "SELECT DISTINCT string_split(p_brand, '#')[2] FROM part",
    "nested_casts_columns": "SELECT n_nationkey, CAST(string_split(n_name, ' ') AS VARCHAR[]), "
                            "CAST('[' || n_nationkey || ', 2]' AS INTEGER[]), "
                            "TRY_CAST(n_name AS INTEGER[]) FROM nation",
}


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_columns_match_jax(cons, name):
    jcon, tcon = cons
    assert _rows(tcon, COLUMNS[name]) == _rows(jcon, COLUMNS[name])


def _reference_names():
    """Every name the reference's functions_nested.py registers."""
    import duckdb_tpu.planner.functions_nested as JN

    src = open(JN.__file__).read()
    names = set(re.findall(r'@register\("(\w+)"\)', src))
    names |= set(re.findall(r'REGISTRY\["(\w+)"\]\s*=', src))
    names |= set(re.findall(r'_list_transform\("(\w+)"', src))
    return sorted(names)


@pytest.mark.parametrize("name", _reference_names())
def test_every_reference_registration_is_ported_or_names_its_item(cons, name):
    """Registered in the port. The ENUM functions read CREATE TYPE's ENUM
    of their argument (tests/test_torch_sequences_types.py), so over a
    VARCHAR they raise, as the JAX package's do."""
    jcon, tcon = cons
    assert name in TF.REGISTRY, name
    if name.startswith("enum_"):
        with pytest.raises(ValueError):
            jcon.sql(f"SELECT {name}('x')")
        with pytest.raises(ValueError, match="expects an ENUM-typed argument"):
            tcon.sql(f"SELECT {name}('x')")


def test_bit_accessors(cons):
    _, tcon = cons
    assert tcon.sql("SELECT get_bit(CAST('0110' AS BIT), 1), "
                    "set_bit(CAST('0110' AS BIT), 0, 1), "
                    "bit_position('11', CAST('0110' AS BIT)), "
                    "bitstring(CAST('11' AS BIT), 4)").rows() == [(1, '1110', 2, '0011')]
    # the integer forms are functions_parity's
    assert tcon.sql("SELECT get_bit(5, 1), get_bit(5, 2), set_bit(4, 0, 1)").rows() == [
        (0, 1, 5)]


def test_type_names(cons):
    """T[], T[N], STRUCT(…) with nested fields, UNION(…), BIT, BITSTRING; a
    user type needs its CREATE TYPE."""
    _, tcon = cons
    got = tcon.sql("SELECT typeof(CAST('[1]' AS BIGINT[])), typeof([1, 2]::INTEGER[2]), "
                   "typeof(CAST('{a: [1]}' AS STRUCT(a INTEGER[], b STRUCT(c VARCHAR)))), "
                   "typeof(union_value(k := 1)::UNION(k INTEGER, s VARCHAR)), "
                   "typeof(CAST('1' AS BITSTRING))").rows()
    assert got == [("BIGINT[]", "INTEGER[2]", "STRUCT(a INTEGER[], b STRUCT(c VARCHAR))",
                     "UNION(k INTEGER, s VARCHAR)", "BIT")]
    with pytest.raises(ValueError, match="unknown type name mood"):
        tcon.sql("SELECT CAST('x' AS mood)")


# -- faults of the reference, held to DuckDB or numpy -----------------------------
def test_fault_b_nested_to_varchar_is_duckdbs_text(cons):
    """(b) CAST([1,2] AS VARCHAR) gives the value's dictionary code in the
    reference; DuckDB formats the value."""
    _, tcon = cons
    assert tcon.sql("SELECT CAST([1,2] AS VARCHAR), CAST({'a': 1, 'b': 'x'} AS VARCHAR), "
                    "CAST(MAP {'k': [1]} AS VARCHAR), CAST(['a', NULL, 'b c'] AS VARCHAR), "
                    "CAST([[1], []] AS VARCHAR), CAST(['x,y'] AS VARCHAR), "
                    "CAST([1.5, 2.0] AS VARCHAR)").rows() == [
        ("[1, 2]", "{'a': 1, 'b': x}", "{k=[1]}", "[a, NULL, b c]", "[[1], []]", "['x,y']",
         "[1.5, 2.0]")]


def test_fault_c_nested_values_at_every_depth(cons):
    """(c) DuckDB's Python API converts at every depth."""
    _, tcon = cons
    assert tcon.sql("SELECT [{'a': 1}, {'a': 2}], {'a': [2, 3]}, [[1], [2, 3]], "
                    "MAP {'k': {'x': [1]}}").rows() == [
        ([{"a": 1}, {"a": 2}], {"a": [2, 3]}, [[1], [2, 3]], {"k": {"x": [1]}})]


def test_fault_d_arrow_fold_binds(cons):
    """(d) (a, x) -> a + x is the two-parameter lambda, as in DuckDB."""
    _, tcon = cons
    assert tcon.sql("SELECT list_reduce([1,2,3], (a, x) -> a + x), "
                    "list_transform([10, 20], (x, i) -> x + i), (1) + 2").rows() == [
        (6, [11, 22], 3)]


def test_fault_e_order_by_a_list_is_element_wise(cons, data_dir):
    """(e) ORDER BY over a LIST column orders element by element, a prefix
    first (the reference orders by first-seen codes)."""
    _, tcon = cons
    sql = ("SELECT s FROM (SELECT l_orderkey, list(l_linenumber) AS s FROM lineitem "
           "WHERE l_orderkey < 40 GROUP BY 1) ORDER BY s")
    got = [r[0] for r in tcon.sql(sql).rows()]
    t = tpch_oracle._Tables(data_dir)
    okey, line = t("lineitem", "l_orderkey"), t("lineitem", "l_linenumber")
    want = sorted(sorted(line[okey == k].tolist()) for k in np.unique(okey[okey < 40]).tolist())
    assert got == want
    assert got[0] == [1] and got[-1] == [1, 2, 3, 4, 5, 6, 7]
    desc = [r[0] for r in tcon.sql(sql + " DESC").rows()]
    assert desc == want[::-1]


def test_nested_comparisons_and_min_max_follow_duckdb(cons):
    """Comparisons of nested values: element-wise, a prefix first, NULL
    after every value inside a list."""
    _, tcon = cons
    assert tcon.sql("SELECT [1,2] < [1,3], [1] < [1,0], [2] > [1,9], [1, NULL] > [1, 5], "
                    "{'a': 1} < {'a': 2}, [1,2] = [1,2], ['b'] > ['a', 'z']").rows() == [
        (True, True, True, True, True, True, True)]
    rows = tcon.sql("SELECT min(string_split(o_clerk, '#')), max(string_split(o_clerk, '#')) "
                    "FROM orders").rows()
    assert rows == [(["Clerk", "000000001"], ["Clerk", "000000010"])]


def test_fault_f_len_of_many_distinct_lists(cons, data_dir):
    """(f) len() of a LIST column with 4,096 or more distinct lists is its
    length (the reference takes the string byte-plane route and raises)."""
    _, tcon = cons
    sql = ("SELECT len(s), count(*) FROM (SELECT l_orderkey, list(l_partkey) AS s "
           "FROM lineitem GROUP BY 1) GROUP BY 1 ORDER BY 1")
    t = tpch_oracle._Tables(data_dir)
    _, counts = np.unique(t("lineitem", "l_orderkey"), return_counts=True)
    k, n = np.unique(counts, return_counts=True)
    assert tcon.sql(sql).rows() == list(zip(k.tolist(), n.tolist()))
    assert tcon.sql("SELECT sum(len(list_filter(s, x -> x > 0))) FROM (SELECT l_orderkey, "
                    "list(l_partkey) AS s FROM lineitem GROUP BY 1)").rows() \
        == [(int(counts.sum()),)]


def test_fault_g_list_value_inside_an_aggregate(cons, data_dir):
    """(g) a columnar list_value in an aggregate's argument runs below the
    aggregate (the reference stacks it above and raises KeyError)."""
    _, tcon = cons
    got = tcon.sql("SELECT p_size, sum(list_value(p_partkey, p_size)[1]), "
                   "max(list_value(p_size, p_partkey)[2]) FROM part GROUP BY 1 ORDER BY 1").rows()
    t = tpch_oracle._Tables(data_dir)
    size, key = t("part", "p_size"), t("part", "p_partkey")
    want = [(s, int(key[size == s].sum()), int(key[size == s].max()))
            for s in np.unique(size).tolist()]
    assert got == want


def test_group_by_a_computed_list(cons, data_dir):
    """A computed LIST group key groups by equality (the reference raises);
    held to numpy."""
    _, tcon = cons
    got = tcon.sql("SELECT string_split(p_mfgr, '#'), count(*) FROM part "
                   "GROUP BY 1 ORDER BY 1").rows()
    t = tpch_oracle._Tables(data_dir)
    mfgr, n = np.unique(t("part", "p_mfgr"), return_counts=True)
    assert got == [(m.decode().split("#"), int(c)) for m, c in zip(mfgr, n)]


# -- the plan nodes ------------------------------------------------------------------
def test_listpack_and_unnest_plan_nodes(cons):
    from duckdb_tpu_torch.planner import plan as P
    from duckdb_tpu_torch.planner.planner import Planner
    from duckdb_tpu_torch.sql.parser import Parser

    _, tcon = cons

    def kinds(sql):
        plan, _ = Planner(tcon.catalog).plan_select(Parser(sql).parse_statements()[0])
        out = []
        while plan is not None:
            out.append(type(plan).__name__)
            plan = getattr(plan, "child", None)
        return out

    assert kinds("SELECT list_value(p_partkey, p_size) FROM part") == \
        ["Project", "ListPack", "Scan"]
    assert kinds("SELECT sum(list_value(p_partkey, 1)[1]) FROM part") == \
        ["Project", "Aggregate", "ListPack", "Scan"]
    assert kinds("SELECT unnest(string_split(p_name, ' ')) FROM part") == \
        ["Project", "Unnest", "Scan"]
    assert kinds("SELECT [1, 2] FROM part") == ["Project", "Scan"]  # constants bind in place
    assert isinstance(P.ListPack, type) and isinstance(P.Unnest, type)


def test_unnest_keeps_row_order_and_pads_shorter_lists(cons):
    _, tcon = cons
    got = tcon.sql("SELECT unnest([1, 2, 3]), unnest(['a']), 7").rows()
    assert got == [(1, "a", 7), (2, None, 7), (3, None, 7)]
    got = tcon.sql("SELECT r_regionkey, unnest(string_split(r_name, ' ')) FROM region "
                   "WHERE r_regionkey IN (1, 3) ORDER BY 1").rows()
    assert got == [(1, "AMERICA"), (3, "EUROPE")]
    assert tcon.sql("SELECT unnest([]) ").rows() == []


def test_listpack_encodes_each_distinct_row_once(cons, data_dir):
    """The ListPack's dictionary holds each distinct row once, in first-seen
    order; NULL elements stay NULL."""
    from duckdb_tpu_torch.execution.executor import Executor
    from duckdb_tpu_torch.planner.planner import Planner
    from duckdb_tpu_torch.sql.parser import Parser

    _, tcon = cons
    sql = "SELECT list_value(n_regionkey, nullif(n_regionkey, 2)) AS l FROM nation"
    plan, out = Planner(tcon.catalog).plan_select(Parser(sql).parse_statements()[0])
    n, cols = Executor(tcon.catalog).materialize(plan, out)
    assert n == 25
    t = tpch_oracle._Tables(data_dir)
    region = t("nation", "n_regionkey").tolist()
    assert list(cols[0].dict_values) == list(dict.fromkeys(
        (r, None if r == 2 else r) for r in region))


def test_host_value_round_trip():
    """physical → Python → physical over every flat kind (NULLs kept)."""
    import datetime
    import decimal

    from duckdb_tpu_torch.types import DATE, DOUBLE, INTEGER, TIMESTAMP, VARCHAR, decimal as dec_t

    cases = [
        (INTEGER, [1, None, -5]),
        (DOUBLE, [1.5, None, -0.0]),
        (dec_t(12, 2), [decimal.Decimal("1.25"), None, decimal.Decimal("-3.00")]),
        (DATE, [datetime.date(1992, 1, 2), None, datetime.date(1969, 12, 31)]),
        (TIMESTAMP, [datetime.datetime(2000, 1, 1, 1, 2, 3, 4), None]),
        (VARCHAR, ["b", None, "a"]),
    ]
    for t, vals in cases:
        data, valid, dv = TN.physical_column(vals, t)
        assert TN.host_pyvals(data, valid, dv, t) == vals, t


def test_encode_objects_keeps_the_references_equality():
    """NaN != NaN gives separate entries; 0.0 == -0.0 merges them."""
    nan = float("nan")
    codes, d = TN.encode_objects([(0.0,), (-0.0,), (nan,), (float("nan"),), (1,), (1.0,)])
    assert codes.tolist() == [0, 0, 1, 2, 3, 3]
    assert len(d) == 4


# -- the nested queries over part and supplier -----------------------------------------
@pytest.mark.parametrize("name", ["nested_words", "nested_pack", "nested_pack_agg"])
def test_nested_query_matches_jax_and_oracle(cons, data_dir, name):
    jcon, tcon = cons
    sql = tpch_oracle.NESTED_QUERIES[name]
    got = tcon.sql(sql).rows()
    assert got == jcon.sql(sql).rows()
    assert got == tpch_oracle.answer(name, data_dir)


def test_join_on_list_keys_compares_values(cons, data_dir):
    """Join keys over two nested dictionaries compare values (ranks in one
    merged order), not first-seen codes."""
    _, tcon = cons
    got = tcon.sql("SELECT count(*) FROM (SELECT string_split(p_brand, '#') AS a FROM part) x, "
                   "(SELECT DISTINCT string_split(p_brand, '#') AS b FROM part) y "
                   "WHERE a = b").rows()
    assert got == [(len(tpch_oracle._Tables(data_dir)("part", "p_brand")),)]


def test_listpack_and_list_keep_wide_sums_exact(cons, data_dir):
    """A DECIMAL(38) sum held beyond int64 (two planes) keeps its value in
    a list_value and in list() (both lose the high plane in the
    reference)."""
    _, tcon = cons
    expr = "sum(l_extendedprice * l_quantity * l_quantity * l_quantity)"
    want = tcon.sql(f"SELECT l_returnflag, {expr} FROM lineitem GROUP BY 1 ORDER BY 1").rows()
    got = tcon.sql(f"SELECT l_returnflag, list_value({expr}) FROM lineitem "
                   "GROUP BY 1 ORDER BY 1").rows()
    assert got == [(k, [v]) for k, v in want]
    got = tcon.sql(f"SELECT list(s ORDER BY k) FROM (SELECT l_returnflag AS k, {expr} AS s "
                   "FROM lineitem GROUP BY 1)").rows()
    assert got == [([v for _, v in want],)]


def test_case_and_if_over_lists_merge_dictionaries(cons, data_dir):
    """CASE and if() over two list dictionaries select values, not codes
    (the reference returns the else branch's code-0 value: [2] for
    CASE WHEN true THEN [1] ELSE [2] END)."""
    _, tcon = cons
    assert tcon.sql("SELECT CASE WHEN true THEN [1] ELSE [2] END, "
                    "CASE WHEN false THEN [1] END, if(false, [3], [4, 5])").rows() == [
        ([1], None, [4, 5])]
    got = tcon.sql("SELECT n_nationkey, CASE WHEN n_nationkey % 2 = 0 THEN "
                   "string_split(n_name, ' ') ELSE ['odd'] END FROM nation ORDER BY 1").rows()
    names = [v.decode() for v in tpch_oracle._Tables(data_dir)("nation", "n_name")]
    assert got == [(k, n.split(" ") if k % 2 == 0 else ["odd"]) for k, n in enumerate(names)]
