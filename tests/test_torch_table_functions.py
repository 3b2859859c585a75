"""The table functions range, generate_series and repeat, duckdb_functions()
and the function catalog in duckdb_tpu_torch (device="cpu"), against
duckdb_tpu, numpy and DuckDB's answers; and the slice as a whole: the five
MORE_QUERIES against the reference and the numpy oracle at SF 0.01, seed
7, with their routes and grouped-sum calls.

range() builds its column with torch.arange on the connection's device,
as a hidden table that lives as long as the plan. The port's
all_function_names() is held to the reference's, less a named set of
exceptions, each tied to the ROADMAP item it waits for. DOUBLE results
within 1e-9 relative, everything else exactly.
"""

import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu_torch.ops import grouped as grouped_mod
from duckdb_tpu_torch.planner import function_catalog
from duckdb_tpu_torch.planner.bound import BindError
from duckdb_tpu_torch.planner.functions import REGISTRY
from duckdb_tpu_torch.testing import tpch_oracle
from duckdb_tpu_torch.testing.tpch_gen import write_tables

torch.set_num_threads(1)

# names the reference binds and the port does not yet, with the item each
# waits for: none is left (the window functions of item 29, the sequence
# functions and the ENUM functions of item 34 and current_setting of item
# 36 are ported)
EXCEPTIONS = {}
# table functions that waited: the file readers (33), the catalog table
# functions (43), views and indexes (34), settings and logs (36); all are
# ported
LATER_TABLE_FUNCTIONS = {"read_csv": 33, "read_parquet": 33, "read_json": 33,
                         "duckdb_tables": 43, "duckdb_columns": 43, "duckdb_types": 43,
                         "duckdb_settings": 36, "duckdb_logs": 36, "duckdb_views": 34,
                         "duckdb_indexes": 34}

# a call of each name the port lists, run as SELECT <call>: over
# constants, or over a TPC-H table where the function is an aggregate or
# reads a column; the operators by their quoted names
SAMPLE_CALLS = {
    # the window functions, over the one row of SELECT without FROM
    'row_number': 'row_number() OVER ()',
    'rank': 'rank() OVER (ORDER BY 1)',
    'dense_rank': 'dense_rank() OVER (ORDER BY 1)',
    'rank_dense': 'rank_dense() OVER (ORDER BY 1)',
    'ntile': 'ntile(2) OVER ()',
    'lag': 'lag(1, 1, 0) OVER ()',
    'lead': 'lead(1) OVER ()',
    'first_value': 'first_value(1) OVER ()',
    'last_value': 'last_value(1) OVER ()',
    'nth_value': 'nth_value(1, 1) OVER ()',
    'percent_rank': 'percent_rank() OVER ()',
    'cume_dist': 'cume_dist() OVER ()',
    'fill': 'fill(1) OVER ()',
    '!=': '"!="(1, 2)',
    '!__postfix': '"!__postfix"(5)',
    '!~~': '"!~~"(\'abc\', \'a%\')',
    '!~~*': '"!~~*"(\'abc\', \'A%\')',
    '%': '"%"(7, 2)',
    '&': '"&"(6, 3)',
    '&&': '"&&"([1, 2], [2, 3])',
    '*': '"*"(7, 2)',
    '**': '"**"(2, 3)',
    '+': '"+"(7, 2)',
    '-': '"-"(7, 2)',
    '/': '"/"(7, 2)',
    '//': '"//"(7, 2)',
    '<': '"<"(1, 2)',
    '<->': '"<->"([1.0, 2.0], [2.0, 3.0])',
    '<<': '"<<"(1, 3)',
    '<=': '"<="(1, 2)',
    '<=>': '"<=>"([1.0, 2.0], [2.0, 3.0])',
    '<>': '"<>"(1, 2)',
    '<@': '"<@"([1], [1, 2])',
    '=': '"="(1, 2)',
    '==': '"=="(1, 2)',
    '>': '">"(1, 2)',
    '>=': '">="(1, 2)',
    '>>': '">>"(8, 1)',
    '@': '"@"(-3)',
    '@>': '"@>"([1, 2], [1])',
    'IS DISTINCT FROM': '"IS DISTINCT FROM"(1, NULL)',
    'IS NOT DISTINCT FROM': '"IS NOT DISTINCT FROM"(1, NULL)',
    '^': '"^"(2, 3)',
    '^@': '"^@"(\'abc\', \'a\')',
    '__between': '"__between"(2, 1, 3)',
    'abs': 'abs(-3)',
    'acos': 'acos(l_tax) FROM lineitem',
    'acosh': 'acosh(l_quantity + 1) FROM lineitem',
    'add': 'add(1, 2)',
    'age': "age(o_orderdate, DATE '1990-01-01') FROM orders",
    'aggregate': "aggregate([1,2,NULL], 'count')",
    'ago': 'ago(INTERVAL 1 DAY)',
    'alias': 'alias(p_size) FROM part',
    'any_value': 'any_value(o_comment) FROM orders',
    'apply': 'apply([1], x -> x)',
    'approx_count_distinct': 'approx_count_distinct(o_custkey) FROM orders',
    'approx_quantile': 'approx_quantile(o_totalprice, 0.5) FROM orders',
    'approx_top_k': 'approx_top_k(n_nationkey % 4, 2) FROM nation',
    'arbitrary': 'arbitrary(o_orderdate) FROM orders',
    'arg_max': 'arg_max(o_comment, o_orderdate) FROM orders',
    'arg_max_null': 'arg_max_null(o_orderkey, o_totalprice) FROM orders',
    'arg_max_nulls_last': 'arg_max_nulls_last(p_name, p_size) FROM part',
    'arg_min': 'arg_min(o_orderkey, o_totalprice) FROM orders',
    'arg_min_null': 'arg_min_null(p_name, p_size) FROM part',
    'arg_min_nulls_last': 'arg_min_nulls_last(p_name, p_size) FROM part',
    'argmax': 'argmax(p_name, p_size) FROM part',
    'argmin': 'argmin(p_name, p_size) FROM part',
    'array_agg': 'array_agg(o_shippriority) FROM orders',
    'array_aggr': "array_aggr([1, 2, 3], 'sum')",
    'array_aggregate': "array_aggregate([1, 2], 'max')",
    'array_append': 'array_append([1], 3)',
    'array_apply': 'array_apply([1], x -> x)',
    'array_cat': 'array_cat([1], [2])',
    'array_concat': 'array_concat([1],[2],[3])',
    'array_contains': "array_contains(['a'], 'a')",
    'array_cosine_distance': 'array_cosine_distance([1, 0], [0, 1])',
    'array_cosine_similarity': 'array_cosine_similarity([1, 2], [2, 1])',
    'array_cross_product': 'array_cross_product([1, 2, 3], [4, 5, 6])',
    'array_distance': 'array_distance([3, 4], [0, 0])',
    'array_distinct': 'array_distinct([1, 1, 2])',
    'array_dot_product': 'array_dot_product([1, 2], [3, 4])',
    'array_extract': 'array_extract([4,5], 2)',
    'array_filter': 'array_filter([1,2], x -> x = 2)',
    'array_grade_up': 'array_grade_up([5, 4, 6])',
    'array_has': 'array_has([1, 2], 2)',
    'array_has_all': 'array_has_all([1], [2])',
    'array_has_any': 'array_has_any([1], [2])',
    'array_indexof': 'array_indexof([5, 6], 6)',
    'array_inner_product': 'array_inner_product([1], [9])',
    'array_intersect': 'array_intersect([1], [1])',
    'array_length': 'array_length([1,2,3])',
    'array_negative_dot_product': 'array_negative_dot_product([2], [3])',
    'array_negative_inner_product': 'array_negative_inner_product([2], [4])',
    'array_pop_back': 'array_pop_back([1,2,3])',
    'array_pop_front': 'array_pop_front([1,2,3])',
    'array_position': 'array_position([1], 1)',
    'array_prepend': 'array_prepend(9, [1])',
    'array_push_back': 'array_push_back([1], 2)',
    'array_push_front': 'array_push_front([1], 0)',
    'array_reduce': 'array_reduce([2,3], lambda a, x: a * x)',
    'array_resize': 'array_resize([1, 2], 4)',
    'array_reverse': 'array_reverse([1,2])',
    'array_reverse_sort': 'array_reverse_sort([1, 3, 2])',
    'array_select': "array_select(['a', 'b'], [2])",
    'array_slice': 'array_slice([1,2,3], -2, -1)',
    'array_sort': 'array_sort([3, 1])',
    'array_to_json': 'array_to_json(o_shippriority) FROM orders',
    'array_to_string': "array_to_string(['a','b'], '-')",
    'array_to_string_comma_default': "array_to_string_comma_default(['a', 'b'])",
    'array_transform': 'array_transform([2], x -> x * x)',
    'array_unique': 'array_unique([1, 1, 2])',
    'array_value': 'array_value(1, 2, 3)',
    'array_where': "array_where(['x', 'y'], [false, true])",
    'array_zip': 'array_zip([1], [2])',
    'ascii': 'ascii(c_comment) FROM customer',
    'asin': 'asin(l_discount) FROM lineitem',
    'asinh': 'asinh(l_extendedprice) FROM lineitem',
    'atan': 'atan(l_quantity) FROM lineitem',
    'atan2': 'atan2(l_tax, l_discount) FROM lineitem',
    'atanh': 'atanh(l_discount) FROM lineitem',
    'avg': 'avg(o_totalprice) FROM orders',
    'bar': 'bar(o_totalprice, 0, 500000, 20) FROM orders',
    'base64': 'base64(p_type) FROM part',
    'bin': 'bin(p_size) FROM part',
    'binom': 'binom(l_linenumber + 3, 2) FROM lineitem',
    'bit_and': 'bit_and(o_custkey) FROM orders',
    'bit_count': 'bit_count(l_partkey) FROM lineitem',
    'bit_length': 'bit_length(p_name) FROM part',
    'bit_or': 'bit_or(o_custkey) FROM orders',
    'bit_position': "bit_position('11', CAST('0110' AS BIT))",
    'bit_xor': 'bit_xor(o_orderkey) FROM orders',
    'bitstring': "bitstring(CAST('11' AS BIT), 4)",
    'bitstring_agg': 'bitstring_agg(n_nationkey) FROM nation',
    'bool_and': 'bool_and(o_totalprice > 1000) FROM orders',
    'bool_or': "bool_or(o_orderstatus = 'P') FROM orders",
    'can_cast_implicitly': 'can_cast_implicitly(1, 1.5)',
    'cardinality': "cardinality(MAP {'a': 1, 'b': 2})",
    'cbrt': 'cbrt(l_extendedprice) FROM lineitem',
    'ceil': 'ceil(5000/2048)',
    'ceiling': 'ceiling(2.5)',
    'century': "century(DATE '2024-03-01')",
    'char_length': 'char_length(p_name) FROM part',
    'character_length': 'character_length(p_type) FROM part',
    'chr': 'chr(65)',
    'coalesce': 'coalesce(sum(o_totalprice), 0) FROM orders',
    'concat': "concat(c_name, '-', c_custkey, NULL, c_acctbal) FROM customer",
    'concat_ws': "concat_ws('-', 'a', 'b', 'c')",
    'constant_or_null': 'constant_or_null(1, 2)',
    'contains': "contains(c_comment, 'the') FROM customer",
    'corr': 'corr(o_totalprice, o_custkey) FROM orders',
    'cos': 'cos(l_tax) FROM lineitem',
    'cosh': 'cosh(l_tax) FROM lineitem',
    'cot': 'cot(l_discount + 0.5) FROM lineitem',
    'count': 'count(*)',
    'count_if': 'count_if(o_totalprice > 100000) FROM orders',
    'count_star': 'count_star() FROM part',
    'countif': 'countif(p_size > 10) FROM part',
    'covar_pop': 'covar_pop(o_totalprice, o_custkey) FROM orders',
    'covar_samp': 'covar_samp(o_totalprice, o_custkey) FROM orders',
    'create_sort_key': "create_sort_key(o_custkey, 'asc nulls last') FROM orders",
    'current_catalog': 'current_catalog()',
    'current_connection_id': 'current_connection_id()',
    'current_database': 'current_database()',
    'current_date': 'current_date',
    'current_query': 'current_query()',
    'current_query_id': 'current_query_id()',
    'current_role': 'current_role()',
    'current_schema': 'current_schema()',
    'current_schemas': 'current_schemas(true)',
    'current_setting': "current_setting('threads')",
    'current_timestamp': 'current_timestamp',
    'current_transaction_id': 'current_transaction_id()',
    'current_user': 'current_user()',
    'currval': "currval('s')",
    'damerau_levenshtein': "damerau_levenshtein(p_container, 'JUMBO PKG') FROM part",
    'date_add': "date_add(DATE '2020-01-01', 3)",
    'date_diff': "date_diff('year', DATE '1990-06-01', o_orderdate) FROM orders",
    'date_part': "date_part('year', DATE '2024-03-01')",
    'date_sub': "date_sub('day', DATE '1992-01-01', o_orderdate) FROM orders",
    'date_trunc': "date_trunc('month', DATE '1992-03-17')",
    'datediff': "datediff('month', o_orderdate, DATE '1999-01-01') FROM orders",
    'datepart': "datepart('month', o_orderdate) FROM orders",
    'datesub': "datesub('week', o_orderdate, DATE '1999-01-01') FROM orders",
    'datetrunc': "datetrunc('month', o_orderdate) FROM orders",
    'day': "day(DATE '2024-03-01')",
    'dayname': 'dayname(o_orderdate) FROM orders',
    'dayofmonth': 'dayofmonth(o_orderdate) FROM orders',
    'dayofweek': "dayofweek(DATE '2024-03-01')",
    'dayofyear': "dayofyear(DATE '2024-03-01')",
    'days_in_month': "days_in_month(DATE '2020-02-03')",
    'decade': "decade(DATE '2024-03-01')",
    'decode': 'decode(encode(p_type)) FROM part',
    'degrees': 'degrees(l_tax) FROM lineitem',
    'divide': 'divide(9, 3)',
    'dow': "dow(DATE '2024-03-01')",
    'doy': "doy(DATE '2024-03-01')",
    'editdist3': "editdist3(c_mktsegment, 'HOUSE') FROM customer",
    'element_at': "element_at(MAP {'k': 7}, 'k')",
    'encode': 'encode(p_container) FROM part',
    'ends_with': "ends_with(c_name, '7') FROM customer",
    'entropy': 'entropy(o_orderstatus) FROM orders',
    'enum_code': "enum_code('a')",
    'enum_first': "enum_first('a')",
    'enum_last': "enum_last('a')",
    'enum_range': "enum_range('a')",
    'enum_range_boundary': "enum_range_boundary('a', 'b')",
    'epoch': 'epoch(o_orderdate) FROM orders',
    'epoch_ms': 'epoch_ms(o_orderdate) FROM orders',
    'epoch_ns': 'epoch_ns(CAST(o_orderdate AS TIMESTAMP)) FROM orders',
    'epoch_us': 'epoch_us(o_orderdate) FROM orders',
    'equi_width_bins': 'equi_width_bins(0, 10, 2, false)',
    'era': 'era(o_orderdate) FROM orders',
    'error': "error('boom')",
    'even': 'even(l_quantity / 3) FROM lineitem',
    'exp': 'exp(l_discount) FROM lineitem',
    'extract': 'extract(year FROM l_shipdate) FROM lineitem',
    'factorial': 'factorial(l_linenumber) FROM lineitem',
    'favg': 'favg(p_retailprice) FROM part',
    'fdiv': 'fdiv(7, 2)',
    'filter': 'filter([1,2], x -> x = 1)',
    'first': 'first(o_orderkey) FROM orders',
    'flatten': 'flatten([[1,2],[3]])',
    'floor': 'floor(random() * 0)',
    'fmod': 'fmod(7, 2)',
    'format': "format('{}-{}', o_orderkey, o_orderstatus) FROM orders",
    'formatReadableDecimalSize': 'formatReadableDecimalSize(1999999)',
    'formatReadableSize': 'formatReadableSize(2047)',
    'format_bytes': 'format_bytes(2000)',
    'formatreadabledecimalsize': 'formatReadableDecimalSize(1999999)',
    'formatreadablesize': 'formatReadableSize(2047)',
    'from_base64': 'from_base64(to_base64(p_type)) FROM part',
    'from_binary': "from_binary('0110')",
    'from_hex': "from_hex('6869')",
    'fsum': 'fsum(o_totalprice) FROM orders',
    'gamma': 'gamma(l_linenumber) FROM lineitem',
    'gcd': 'gcd(l_orderkey, l_partkey) FROM lineitem',
    'gen_random_uuid': 'gen_random_uuid()',
    'generate_series': 'generate_series(3)',
    'geomean': 'geomean(l_quantity) FROM lineitem',
    'geometric_mean': 'geometric_mean(l_extendedprice) FROM lineitem',
    'get_bit': "get_bit(CAST('0110' AS BIT), 1)",
    'get_current_timestamp': 'get_current_timestamp()',
    'getenv': "getenv('DUCKDB_TPU_TORCH_UNSET_VARIABLE')",
    'getvariable': "getvariable('nothing')",
    'glob': "glob(p_type, 'PROMO*') FROM part",
    'grade_up': 'grade_up([2, 1])',
    'greatest': 'greatest(1, NULL, 3)',
    'greatest_common_divisor': 'greatest_common_divisor(12, 18)',
    'group_concat': 'group_concat(n_name) FROM nation',
    'hamming': "hamming('abc', 'abd')",
    'hash': 'hash(o_custkey) FROM orders',
    'hex': 'hex(c_mktsegment) FROM customer',
    'histogram': 'histogram(n_nationkey % 3) FROM nation',
    'histogram_exact': 'histogram_exact(n_nationkey % 4, [0, 1]) FROM nation',
    'hour': "hour(TIMESTAMP '2024-03-01 10:20:30')",
    'if': 'if(false, [3], [4, 5])',
    'ifnull': 'ifnull(nullif(o_shippriority, 0), -1) FROM orders',
    'iif': 'iif(o_orderkey % 2 = 0, o_custkey, NULL) FROM orders',
    'ilike_escape': "ilike_escape(p_name, '%GREEN%', '!') FROM part",
    'in_search_path': "in_search_path('memory', 'main')",
    'initcap': 'initcap(c_comment) FROM customer',
    'instr': "instr(c_name, '00') FROM customer",
    'is_histogram_other_bin': "is_histogram_other_bin('')",
    'isfinite': 'isfinite(l_tax) FROM lineitem',
    'isinf': 'isinf(ln(l_discount)) FROM lineitem',
    'isnan': 'isnan(l_tax) FROM lineitem',
    'isodow': 'isodow(o_orderdate) FROM orders',
    'isoyear': 'isoyear(o_orderdate) FROM orders',
    'jaccard': "jaccard(p_name, 'almond') FROM part",
    'jaro_similarity': "jaro_similarity(p_type, 'PROMO BURNISHED') FROM part",
    'jaro_winkler_similarity': "jaro_winkler_similarity(p_container, 'SM CASE') FROM part",
    'json': 'json(\'{"a": 1}\')',
    'json_array': 'json_array(o_orderstatus, o_custkey % 3, NULL) FROM orders',
    'json_array_length': "json_array_length('[1, 2]')",
    'json_contains': 'json_contains(\'{"a": [1, 2]}\', \'2\')',
    'json_exists': 'json_exists(\'{"a": 1}\', \'$.a\')',
    'json_extract': 'json_extract(\'{"a": {"b": [5, 6]}}\', \'$.a.b[1]\')',
    'json_extract_path': 'json_extract_path(\'{"a": 1}\', \'$.a\')',
    'json_extract_path_text': 'json_extract_path_text(\'{"a": 1}\', \'$.a\')',
    'json_extract_string': 'json_extract_string(\'{"a": 1}\', \'$.a\')',
    'json_group_array': 'json_group_array(n_name) FROM nation',
    'json_keys': 'json_keys(\'{"a": 1}\')',
    'json_merge_patch': 'json_merge_patch(\'{"a": 1, "b": 2}\', \'{"b": null, "c": 3}\')',
    'json_object': "json_object('k', o_orderkey % 10, 'p', o_orderpriority) FROM orders",
    'json_pretty': 'json_pretty(\'{"a": 1}\')',
    'json_quote': "json_quote('a')",
    'json_strip_nulls': 'json_strip_nulls(\'{"a": null, "b": 1}\')',
    'json_structure': 'json_structure(\'{"a": 1}\')',
    'json_type': "json_type('[1]')",
    'json_typeof': 'json_typeof(\'{"a": 1}\')',
    'json_valid': "json_valid('{')",
    'json_value': 'json_value(\'{"a": 1}\', \'$.a\')',
    'julian': 'julian(o_orderdate) FROM orders',
    'kahan_sum': 'kahan_sum(o_custkey) FROM orders',
    'kurtosis': 'kurtosis(o_totalprice) FROM orders',
    'kurtosis_pop': 'kurtosis_pop(o_custkey) FROM orders',
    'last': 'last(o_orderkey) FROM orders',
    'last_day': 'last_day(o_orderdate) FROM orders',
    'lcase': 'lcase(c_phone) FROM customer',
    'lcm': 'lcm(l_linenumber, l_suppkey) FROM lineitem',
    'least': 'least(NULL, 2, 5)',
    'least_common_multiple': 'least_common_multiple(4, 6)',
    'left': 'left(c_name, 3) FROM customer',
    'left_grapheme': 'left_grapheme(p_name, 3) FROM part',
    'len': 'len(c_phone) FROM customer',
    'length': 'length(c_comment) FROM customer',
    'length_grapheme': 'length_grapheme(p_name) FROM part',
    'levenshtein': "levenshtein('abc', 'abd')",
    'lgamma': 'lgamma(l_quantity) FROM lineitem',
    'like_escape': "like_escape(p_name, '%green!%%', '!') FROM part",
    'list': 'list(o_orderkey) FROM orders',
    'list_aggr': "list_aggr([1,2,3], 'max')",
    'list_aggregate': "list_aggregate([1,2,3], 'sum')",
    'list_any_value': 'list_any_value([3])',
    'list_append': 'list_append([1], 2)',
    'list_apply': 'list_apply([3], x -> -x)',
    'list_approx_count_distinct': 'list_approx_count_distinct([1, 2, 2])',
    'list_avg': 'list_avg([1,2])',
    'list_bit_and': 'list_bit_and([3, 6])',
    'list_bit_or': 'list_bit_or([3, 6])',
    'list_bit_xor': 'list_bit_xor([1,3])',
    'list_bool_and': 'list_bool_and([true, false])',
    'list_bool_or': 'list_bool_or([false, true])',
    'list_cat': 'list_cat([], [1])',
    'list_concat': 'list_concat([1],[2,3])',
    'list_contains': 'list_contains([1,2], 2)',
    'list_cosine_distance': 'list_cosine_distance([1, 2], [2, 4])',
    'list_cosine_similarity': 'list_cosine_similarity([1, 0], [1, 1])',
    'list_count': 'list_count([1,NULL])',
    'list_distance': 'list_distance([1, 2, 3], [1, 2, 5])',
    'list_distinct': 'list_distinct([1,1,NULL,2])',
    'list_dot_product': 'list_dot_product([1.0, 2.0], [3.0, 4.0])',
    'list_element': 'list_element([4,5], 1)',
    'list_entropy': 'list_entropy([1,2])',
    'list_extract': 'list_extract([1, 2], 1)',
    'list_filter': 'list_filter([1,2,3,4], x -> x > 2)',
    'list_first': 'list_first([7,8])',
    'list_grade_up': 'list_grade_up([3, 1, 2])',
    'list_has': 'list_has([1,2], 3)',
    'list_has_all': 'list_has_all([1, 2, 3], [1, 3])',
    'list_has_any': 'list_has_any([1, 2], [5, 2])',
    'list_indexof': 'list_indexof([5], 9)',
    'list_inner_product': 'list_inner_product([1.5, 2.0], [2.0, 4.0])',
    'list_intersect': 'list_intersect([1, 2, 3, 2], [2, 3, 4])',
    'list_kurtosis': 'list_kurtosis([1.0, 2.0, 3.0, 7.0])',
    'list_kurtosis_pop': 'list_kurtosis_pop([1.0, 2.0, 3.0, 7.0])',
    'list_last': 'list_last([7,8])',
    'list_length': 'list_length([])',
    'list_mad': 'list_mad([1.0, 2.0, 4.0])',
    'list_max': 'list_max([4,2])',
    'list_median': 'list_median([1,2,3])',
    'list_min': 'list_min([4,2])',
    'list_mode': 'list_mode([1,1,2])',
    'list_negative_dot_product': 'list_negative_dot_product([1, 2], [3, 4])',
    'list_negative_inner_product': 'list_negative_inner_product([1, 1], [2, 2])',
    'list_pack': 'list_pack(1, 2)',
    'list_position': 'list_position([5,6,7], 7)',
    'list_prepend': 'list_prepend(0, [1])',
    'list_product': 'list_product([2,3])',
    'list_reduce': 'list_reduce([1,2,3], lambda a, x: a + x)',
    'list_resize': 'list_resize([1, 2, 3], 2)',
    'list_reverse': 'list_reverse([1,2,3])',
    'list_reverse_sort': 'list_reverse_sort([3,1,2])',
    'list_select': 'list_select([10, 20, 30], [3, 1, 7])',
    'list_sem': 'list_sem([1.0, 2.0, 4.0])',
    'list_skewness': 'list_skewness([1.0,2.0,4.0,8.0])',
    'list_slice': 'list_slice([1,2,3,4], 2, 3)',
    'list_sort': 'list_sort([3,1,NULL,2])',
    'list_stddev_pop': 'list_stddev_pop([1,2,3])',
    'list_stddev_samp': 'list_stddev_samp([1.0,2.0,3.0])',
    'list_string_agg': "list_string_agg(['x','y'])",
    'list_sum': 'list_sum([1,2,3])',
    'list_transform': 'list_transform([1,2,3], x -> x + 1)',
    'list_unique': 'list_unique([1,1,NULL,2])',
    'list_value': 'list_value(n_nationkey, n_regionkey) FROM nation',
    'list_var_pop': 'list_var_pop([1.0, 2.0, 4.0])',
    'list_var_samp': 'list_var_samp([1,2,3])',
    'list_where': 'list_where([1, 2, 3], [true, false, true])',
    'list_zip': "list_zip([1, 2], ['a'])",
    'listagg': "listagg(n_name, ';') FROM nation",
    'ln': 'ln(l_extendedprice) FROM lineitem',
    'log': 'log(l_quantity) FROM lineitem',
    'log10': 'log10(l_extendedprice) FROM lineitem',
    'log2': 'log2(l_quantity) FROM lineitem',
    'lower': 'lower(c_name) FROM customer',
    'lpad': "lpad(c_name, 20, 'xy') FROM customer",
    'ltrim': 'ltrim(c_comment) FROM customer',
    'lttb': 'lttb(n_nationkey, CAST(n_nationkey AS DOUBLE) * 2, 3) FROM nation',
    'mad': 'mad(o_totalprice) FROM orders',
    'make_date': 'make_date(2024, 3, 31)',
    'make_time': 'make_time(o_orderkey % 24, o_custkey % 60, 30.25) FROM orders',
    'make_timestamp': 'make_timestamp(o_orderkey * 1000000) FROM orders',
    'make_timestamp_ms': 'make_timestamp_ms(o_orderkey) FROM orders',
    'make_timestamp_ns': 'make_timestamp_ns(o_orderkey * 1000000) FROM orders',
    'map': "map(['a', 'b'], [1, 2])",
    'map_concat': "map_concat(MAP {'a': 1}, MAP {'b': 2, 'a': 3})",
    'map_contains': "map_contains(MAP {'a': 1}, 'a')",
    'map_contains_value': "map_contains_value(MAP {'a': 1}, 1)",
    'map_entries': "map_entries(MAP {'k': 1, 'j': 2})",
    'map_extract': "map_extract(MAP {'k': 7}, 'k')",
    'map_extract_value': "map_extract_value(MAP {'k': 7}, 'k')",
    'map_from_entries': "map_from_entries([{'k': 'a', 'v': 1}])",
    'map_keys': "map_keys(MAP {'a': 1, 'b': 2})",
    'map_pack_kv': "map_pack_kv('a', 1)",
    'map_values': "map_values(MAP {'a': 1, 'b': 2})",
    'max': 'max(l_suppkey) FROM lineitem',
    'max_by': 'max_by(o_custkey, o_totalprice) FROM orders',
    'md5': 'md5(c_name) FROM customer',
    'md5_number': 'md5_number(p_type) FROM part',
    'mean': 'mean(p_size) FROM part',
    'median': 'median(o_totalprice) FROM orders',
    'microsecond': "microsecond(TIMESTAMP '2024-03-01 10:20:30')",
    'millennium': 'millennium(o_orderdate) FROM orders',
    'millisecond': "millisecond(TIMESTAMP '2024-03-01 10:20:30')",
    'min': 'min(c_acctbal) FROM customer',
    'min_by': 'min_by(o_orderkey, o_clerk) FROM orders',
    'minute': "minute(TIME '12:34:56')",
    'mismatches': "mismatches(c_mktsegment, 'MACHINERY') FROM customer",
    'mod': 'mod(-7, 3)',
    'mode': 'mode(o_orderstatus) FROM orders',
    'month': 'month(o_orderdate) FROM orders',
    'monthname': 'monthname(o_orderdate) FROM orders',
    'multiply': 'multiply(2, 4)',
    'nanosecond': "nanosecond(TIMESTAMP '2024-03-01 10:20:30')",
    'nextafter': 'nextafter(l_tax, 1) FROM lineitem',
    'nextval': "nextval('s')",
    'nfc_normalize': 'nfc_normalize(p_name) FROM part',
    'normalized_interval': "normalized_interval(INTERVAL '1 day')",
    'not_ilike_escape': "not_ilike_escape(p_container, 'sm _ase', '!') FROM part",
    'not_like_escape': "not_like_escape(p_type, 'PROMO!%%', '!') FROM part",
    'now': 'now()',
    'nullif': 'nullif(o_custkey % 7, 3) FROM orders',
    'octet_length': 'octet_length(p_name) FROM part',
    'ord': 'ord(c_comment) FROM customer',
    'overlay': "overlay(p_name PLACING 'XY' FROM 3 FOR 2) FROM part",
    'parse_dirname': "parse_dirname('/a/b/c.txt')",
    'parse_dirpath': "parse_dirpath('/a/b/c.txt')",
    'parse_filename': "parse_filename('/a/b/c.txt')",
    'parse_formatted_bytes': "parse_formatted_bytes('2 MiB')",
    'parse_path': "parse_path('/usr/local/bin')",
    'path_join': "path_join(o_orderstatus, 'x', 'y.csv') FROM orders",
    'pi': 'pi()',
    'position': "position(c_phone, '-') FROM customer",
    'pow': 'pow(l_quantity, 2) FROM lineitem',
    'power': 'power(l_tax, 0.5) FROM lineitem',
    'prefix': "prefix(c_comment, 'a') FROM customer",
    'printf': "printf('%d-%s', 1, 'a')",
    'product': 'product(1 + o_custkey % 3) FROM orders',
    'quantile': 'quantile(o_custkey, 0.25) FROM orders',
    'quantile_cont': 'quantile_cont(o_totalprice, 0.75) FROM orders',
    'quantile_disc': 'quantile_disc(o_orderdate, 0.5) FROM orders',
    'quarter': "quarter(DATE '2024-03-01')",
    'radians': 'radians(l_quantity) FROM lineitem',
    'random': 'random()',
    'range': 'range(4)',
    'reduce': 'reduce([5], lambda a, x: a - x)',
    'regexp_escape': 'regexp_escape(p_container) FROM part',
    'regexp_extract': "regexp_extract(c_phone, '([0-9]+)-', 1) FROM customer",
    'regexp_extract_all': "regexp_extract_all(p_name, '[a-z]+') FROM part",
    'regexp_full_match': "regexp_full_match(p_container, 'SM .*') FROM part",
    'regexp_matches': "regexp_matches('abc', 'b')",
    'regexp_replace': "regexp_replace(c_comment, '[aeiou]', '_') FROM customer",
    'regexp_split_to_array': "regexp_split_to_array(p_container, ' ') FROM part",
    'regr_avgx': 'regr_avgx(o_totalprice, o_custkey) FROM orders',
    'regr_avgy': 'regr_avgy(p_size, p_retailprice) FROM part',
    'regr_count': 'regr_count(o_totalprice, o_custkey) FROM orders',
    'regr_intercept': 'regr_intercept(p_size, p_retailprice) FROM part',
    'regr_r2': 'regr_r2(p_size, p_retailprice) FROM part',
    'regr_slope': 'regr_slope(p_size, p_retailprice) FROM part',
    'regr_sxx': 'regr_sxx(p_size, p_retailprice) FROM part',
    'regr_sxy': 'regr_sxy(o_totalprice, o_custkey) FROM orders',
    'regr_syy': 'regr_syy(p_size, p_retailprice) FROM part',
    'repeat': "repeat('ab', 3)",
    'replace': "replace(c_name, '0', 'o') FROM customer",
    'reservoir_quantile': 'reservoir_quantile(p_size, 0.5) FROM part',
    'reverse': 'reverse(c_name) FROM customer',
    'right': 'right(c_phone, 4) FROM customer',
    'right_grapheme': 'right_grapheme(p_type, 4) FROM part',
    'round': 'round(1.5, NULL)',
    'round_even': 'round_even(2.5, 0)',
    'roundbankers': 'roundbankers(3.45, 1)',
    'row': "row(1, 'x')",
    'row_to_json': 'row_to_json(o_orderstatus) FROM orders',
    'rpad': "rpad(c_mktsegment, 12, '-') FROM customer",
    'rtrim': 'rtrim(c_comment) FROM customer',
    'second': "second(TIME '12:34:56')",
    'sem': 'sem(o_totalprice) FROM orders',
    'session_user': 'session_user()',
    'set_bit': "set_bit(CAST('0110' AS BIT), 0, 1)",
    'setseed': 'setseed(0.42)',
    'setval': "setval('s', 1)",
    'sha1': 'sha1(p_type) FROM part',
    'sha256': 'sha256(p_name) FROM part',
    'sign': 'sign(l_discount - 0.05) FROM lineitem',
    'signbit': 'signbit(l_tax - 0.04) FROM lineitem',
    'sin': 'sin(l_tax) FROM lineitem',
    'sinh': 'sinh(l_discount) FROM lineitem',
    'skewness': 'skewness(o_totalprice) FROM orders',
    'split': "split('a', ' ')",
    'split_part': "split_part(c_phone, '-', 2) FROM customer",
    'sqrt': 'sqrt(2.0)',
    'starts_with': "starts_with(c_phone, '1') FROM customer",
    'stats': 'stats(5)',
    'stddev': 'stddev(o_totalprice) FROM orders',
    'stddev_pop': 'stddev_pop(o_totalprice) FROM orders',
    'stddev_samp': 'stddev_samp(o_totalprice) FROM orders',
    'str_split': "str_split('x,y', ',')",
    'str_split_regex': "str_split_regex(p_name, 'e') FROM part",
    'strftime': "strftime(o_orderdate, '%Y-%m') FROM orders",
    'string_agg': "string_agg(o_comment, ',') FROM orders",
    'string_split': "string_split('a b c', ' ')",
    'string_split_regex': "string_split_regex(p_type, ' +') FROM part",
    'string_to_array': "string_to_array('1-2', '-')",
    'strip_accents': 'strip_accents(p_name) FROM part',
    'strlen': 'strlen(c_name) FROM customer',
    'strpos': "strpos(c_comment, 'the') FROM customer",
    'strptime': "strptime('2020-03-04 05:06:07', '%Y-%m-%d %H:%M:%S')",
    'struct_concat': "struct_concat({'a': 1}, {'b': 2})",
    'struct_contains': "struct_contains({'a': 1, 'b': 2}, 2)",
    'struct_extract': "struct_extract({'q': 3}, 'q')",
    'struct_extract_at': "struct_extract_at({'a': 1, 'b': 'x'}, 2)",
    'struct_has': "struct_has({'a': 1}, 'a')",
    'struct_indexof': "struct_indexof({'a': 7}, 9)",
    'struct_insert': "struct_insert({'a': 1}, b := 2, c := 'x')",
    'struct_keys': "struct_keys({'a': 1, 'b': 2})",
    'struct_pack': "struct_pack(a := 1, b := 'y')",
    'struct_pack_kv': "struct_pack_kv('a', 1)",
    'struct_position': "struct_position({'a': 7, 'b': 8}, 8)",
    'struct_update': "struct_update({'a': 1, 'b': 2}, b := 3)",
    'struct_values': "struct_values({'a': 1, 'b': 2})",
    'substr': 'substr(c_phone, 4) FROM customer',
    'substring': 'substring(c_phone, 1, 2) FROM customer',
    'substring_grapheme': 'substring_grapheme(p_name, 2, 5) FROM part',
    'subtract': 'subtract(5, 1)',
    'suffix': "suffix(c_name, '9') FROM customer",
    'sum': 'sum(o_totalprice) FROM orders',
    'sum_no_overflow': 'sum_no_overflow(p_size) FROM part',
    'sumkahan': 'sumkahan(p_retailprice) FROM part',
    'tan': 'tan(l_discount) FROM lineitem',
    'tanh': 'tanh(l_quantity) FROM lineitem',
    'time_bucket': "time_bucket(INTERVAL '1 day', o_orderdate) FROM orders",
    'timezone': "timezone('UTC', TIMESTAMP '2024-01-02 03:04:05')",
    'timezone_hour': "timezone_hour(TIMESTAMPTZ '2024-01-02 03:04:05+00')",
    'timezone_minute': "timezone_minute(TIMESTAMP '2024-01-02 03:04:05')",
    'to_base': 'to_base(l_partkey, 16) FROM lineitem',
    'to_base64': 'to_base64(p_name::BLOB) FROM part',
    'to_binary': 'to_binary(p_size % 7) FROM part',
    'to_centuries': 'to_centuries(1)',
    'to_days': 'to_days(o_custkey) FROM orders',
    'to_decades': 'to_decades(1)',
    'to_hex': "to_hex('az')",
    'to_hours': 'to_hours(o_orderkey % 24) FROM orders',
    'to_json': 'to_json(o_totalprice) FROM orders',
    'to_microseconds': 'to_microseconds(o_orderkey) FROM orders',
    'to_millennia': 'to_millennia(1)',
    'to_milliseconds': 'to_milliseconds(o_custkey) FROM orders',
    'to_minutes': 'to_minutes(o_custkey % 60) FROM orders',
    'to_months': 'to_months(3)',
    'to_quarters': 'to_quarters(1)',
    'to_seconds': 'to_seconds(o_orderkey % 60) FROM orders',
    'to_timestamp': 'to_timestamp(o_orderkey * 1000) FROM orders',
    'to_weeks': 'to_weeks(o_orderkey % 5) FROM orders',
    'to_years': 'to_years(2)',
    'today': 'today()',
    'transaction_timestamp': 'transaction_timestamp()',
    'translate': "translate(c_phone, '-1', '_I') FROM customer",
    'trim': 'trim(c_comment) FROM customer',
    'trunc': 'trunc(-l_extendedprice / 7) FROM lineitem',
    'try_strptime': "try_strptime('2024-03-04', '%Y-%m-%d')",
    'txid_current': 'txid_current()',
    'typeof': 'typeof(CAST(o_comment AS VARBINARY)) FROM orders',
    'ucase': 'ucase(c_mktsegment) FROM customer',
    'unbin': "unbin('0100000101')",
    'unhex': "unhex('4142')",
    'unicode': 'unicode(c_name) FROM customer',
    'union_extract': "union_extract(union_value(k := 2), 'k')",
    'union_tag': 'union_tag(union_value(k := 2))',
    'union_value': 'union_value(k := 2)',
    'unpivot_list': 'unpivot_list(1, 2)',
    'upper': 'upper(c_comment) FROM customer',
    'url_decode': 'url_decode(url_encode(p_type)) FROM part',
    'url_encode': 'url_encode(p_name) FROM part',
    'user': 'user()',
    'uuid': 'uuid()',
    'uuid_extract_timestamp': "uuid_extract_timestamp('01890a5d-ac96-774b-bcce-b302099a8057')",
    'uuid_extract_version': 'uuid_extract_version(uuidv7())',
    'uuidv4': 'uuidv4()',
    'uuidv7': 'uuidv7()',
    'var_pop': 'var_pop(o_totalprice) FROM orders',
    'var_samp': 'var_samp(o_custkey) FROM orders',
    'variance': 'variance(o_totalprice) FROM orders',
    'vector_type': 'vector_type(o_orderstatus) FROM orders',
    'version': 'version()',
    'wavg': 'wavg(l_discount, l_tax) FROM lineitem',
    'week': 'week(o_orderdate) FROM orders',
    'weekday': 'weekday(o_orderdate) FROM orders',
    'weekofyear': 'weekofyear(o_orderdate) FROM orders',
    'weighted_avg': 'weighted_avg(l_quantity, l_discount) FROM lineitem',
    'xor': 'xor(o_orderkey, o_custkey) FROM orders',
    'year': 'year(o_orderdate) FROM orders',
    'yearweek': 'yearweek(o_orderdate) FROM orders',
    '|': '"|"(6, 3)',
    '||': '"||"(\'a\', \'b\')',
    '~': '"~"(5)',
    '~~': '"~~"(\'abc\', \'a%\')',
    '~~*': '"~~*"(\'abc\', \'A%\')',
    '~~~': '"~~~"(\'abc\', \'a*\')',
}
# what a sample call raises when it runs: error() is a function that raises
RAISES = {"error": "Invalid Input Error: boom",
          # the sample calls name a sequence no CREATE SEQUENCE made, and
          # pass the ENUM functions a VARCHAR
          **dict.fromkeys(("nextval", "currval", "setval"),
                          'Sequence with name "s" does not exist'),
          **dict.fromkeys(("enum_range", "enum_first", "enum_last", "enum_code",
                           "enum_range_boundary"), "expects an ENUM-typed argument")}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_gen_table_functions")
    write_tables(str(root), 0.01, seed=7)
    return str(root)


@pytest.fixture(scope="module")
def cons(data_dir):
    jcon = duckdb_tpu.connect()
    jcon.load_tpch(data_dir)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    return jcon, tcon


def _close(got, want):
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9, abs=1e-12), (g, w)
            else:
                assert a == b and type(a) is type(b), (g, w)


SQL = {
    "range": "SELECT * FROM range(5)",
    "range_bounds": "SELECT * FROM range(2, 11, 3)",
    "range_down": "SELECT * FROM range(5, -6, -2)",
    "range_empty": "SELECT count(*) FROM range(3, 3)",
    "generate_series": "SELECT * FROM generate_series(1, 3)",
    "generate_series_step": "SELECT * FROM generate_series(10, 0, -5)",
    "range_agg": "SELECT count(*), sum(range), min(range), max(range) FROM range(100000)",
    "range_where": "SELECT count(*), sum(r.range) FROM range(1000) r WHERE r.range % 7 = 3",
    "range_join": "SELECT count(*) FROM range(1, 26) t JOIN nation ON n_nationkey = t.range",
    "range_group": "SELECT range % 4 AS k, count(*), sum(range) FROM range(10001) "
                   "GROUP BY 1 ORDER BY 1",
    "repeat_text": "SELECT * FROM repeat('ab', 3)",
    "repeat_int": "SELECT count(*), sum(repeat) FROM repeat(7, 5)",
}


@pytest.mark.parametrize("name", sorted(SQL))
def test_table_function_matches_jax(cons, name):
    jcon, tcon = cons
    got = sorted(tcon.sql(SQL[name]).rows())
    _close(got, sorted(jcon.sql(SQL[name]).rows()))


def test_small_answers(cons):
    """The acceptance forms, and DuckDB's names for the columns."""
    _, tcon = cons
    assert tcon.sql("SELECT * FROM range(3)").rows() == [(0,), (1,), (2,)]
    assert tcon.sql("SELECT * FROM generate_series(1, 3)").rows() == [(1,), (2,), (3,)]
    assert tcon.sql("SELECT generate_series FROM generate_series(2, 2)").rows() == [(2,)]
    assert tcon.sql("SELECT x FROM range(1) t(x)").rows() == [(0,)]
    (n,), = tcon.sql("SELECT count(*) FROM duckdb_functions()").rows()
    assert n == len(function_catalog.function_types()) > 500


def test_range_is_built_on_the_connection_device(cons):
    """range()'s column is made by torch.arange on the catalog's device, as
    a hidden table the plan owns; the catalog keeps exact statistics."""
    _, tcon = cons
    sql = "SELECT sum(range) FROM range(10, 70000)"
    assert tcon.sql(sql).rows() == [(sum(range(10, 70000)),)]
    hidden = tcon._plan_tables[sql]
    assert len(hidden) == 1 and hidden[0].startswith("__range_")
    entry = tcon.catalog.get_table(hidden[0])
    col = entry.device_column("range")
    assert col.data.device == tcon.device and entry.nrows == 69990
    assert col.data.dtype == torch.int64 and int(col.data[:entry.nrows].sum()) == sum(
        range(10, 70000))
    st = entry.stats_for("range")
    assert (st.min_val, st.max_val, st.n_unique) == (10, 69999, 69990)
    tcon._clear_plan_cache()
    assert not tcon.catalog.has_table(hidden[0])


def test_duckdb_functions_counts_equal_the_registry(cons):
    _, tcon = cons
    rows = dict(tcon.sql("SELECT function_type, count(*) FROM duckdb_functions() "
                         "GROUP BY 1").rows())
    types = function_catalog.function_types()
    want = {}
    for t in types.values():
        want[t] = want.get(t, 0) + 1
    assert rows == want and set(rows) == {"scalar", "aggregate", "macro"}
    names = {r[0] for r in tcon.sql("SELECT function_name FROM duckdb_functions() "
                                    "WHERE function_type = 'aggregate'").rows()}
    assert {"sum", "histogram", "string_agg"} <= names


def test_catalog_holds_the_reference_names():
    """Every name of the reference's all_function_names() is in the port's,
    but the named exceptions; SAMPLE_CALLS holds a call of each name the
    port lists. No name of functions_more, functions_parity or the JSON
    functions is an exception but those needing sequences, settings or
    ENUM types."""
    from duckdb_tpu.planner import function_catalog as jcat

    ref = jcat.all_function_names()
    port = function_catalog.all_function_names()
    assert ref - port == {n for n in EXCEPTIONS if n not in REGISTRY}
    assert set(SAMPLE_CALLS) == port
    assert not EXCEPTIONS and "current_setting" in REGISTRY


@pytest.mark.parametrize("name", sorted(SAMPLE_CALLS))
def test_each_listed_name_binds(cons, name):
    """The port binds and runs a call of each name it lists; an exception
    refuses its call as not yet ported, naming its ROADMAP item."""
    _, tcon = cons
    sql = f"SELECT {SAMPLE_CALLS[name]}"
    if name in EXCEPTIONS:
        with pytest.raises(BindError, match=f"ROADMAP item {EXCEPTIONS[name]}\\).*not yet "
                                            "ported"):
            tcon.sql(sql)
    elif name in RAISES:
        with pytest.raises(ValueError, match=RAISES[name]):
            tcon.sql(sql).rows()
    else:
        assert tcon.sql(sql).rows()


@pytest.mark.parametrize("name", sorted(LATER_TABLE_FUNCTIONS))
def test_later_table_functions_name_their_item(cons, name):
    """The table functions still to port name their ROADMAP item; the
    catalog functions of item 43 are ported and give the JAX package's
    rows."""
    jcon, tcon = cons
    arg = "'x.csv'" if name.startswith("read_") else ""
    sql = f"SELECT * FROM {name}({arg})"
    if LATER_TABLE_FUNCTIONS[name] in (34, 43):
        assert tcon.sql(sql).rows() == jcon.sql(sql).rows()
        return
    if LATER_TABLE_FUNCTIONS[name] == 36:  # the JAX package's columns and types
        mine, theirs = tcon.sql(sql), jcon.sql(sql)
        assert mine.names == theirs.names
        assert [str(t) for t in mine.types] == [str(t) for t in theirs.types]
        return
    if LATER_TABLE_FUNCTIONS[name] == 33:  # ported: there is no file x.csv
        with pytest.raises(ValueError, match="No files found"):
            tcon.sql(sql)
        with pytest.raises(FileNotFoundError):
            jcon.sql(sql)
        return
    with pytest.raises(ValueError, match=f"ROADMAP item {LATER_TABLE_FUNCTIONS[name]}"
                                         ".*not yet ported"):
        tcon.sql(sql)


def test_unknown_table_function(cons):
    _, tcon = cons
    with pytest.raises(ValueError, match="Table Function with name nope does not exist"):
        tcon.sql("SELECT * FROM nope(1)")
    with pytest.raises(ValueError, match="step of range"):
        tcon.sql("SELECT * FROM range(1, 5, 0)")


# -- the slice as a whole: MORE_QUERIES ------------------------------------------------
ROUTES = {"more_dates": {"dense": 1}, "more_math": {"dense": 1},
          "more_text": {"general_aggregate": 1, "general_perfect": 1},
          "parity_lists": {"general_aggregate": 1, "general_sort_group": 1},
          "json_orders": {"general_aggregate": 1, "general_perfect": 1}}
# (vectors, slots) of each grouped-sum call at SF 0.01
KERNEL_CALLS = {"more_dates": [(19, 5)], "more_math": [(8, 20)],
                "more_text": [(1, 6), (1, 5), (2, 5), (2, 5), (2, 5), (1, 5)],
                "parity_lists": [(1, 5), (2, 5), (2, 5)],
                "json_orders": [(1, 6), (1, 5), (2, 5)]}


@pytest.mark.parametrize("name", sorted(tpch_oracle.MORE_QUERIES))
def test_more_query_matches_oracle_and_jax(cons, data_dir, name):
    jcon, tcon = cons
    sql = tpch_oracle.MORE_QUERIES[name]
    got = tcon.sql(sql).rows()
    _close(got, tpch_oracle.answer(name, data_dir))
    if name != "parity_lists":  # the reference raises there (faults (j), (k))
        _close(got, jcon.sql(sql).rows())


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_more_query_route_and_grouped_sum_calls(data_dir, monkeypatch, name):
    seen = []
    orig = grouped_mod.grouped_sum_i64

    def recording(dense, vectors, nseg):
        seen.append((len(vectors), nseg))
        return orig(dense, vectors, nseg)

    monkeypatch.setattr(grouped_mod, "grouped_sum_i64", recording)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    tcon.load_tpch(data_dir)
    tcon.sql(tpch_oracle.MORE_QUERIES[name]).rows()
    assert dict(tcon.routes) == ROUTES[name]
    assert seen == KERNEL_CALLS[name]


def test_range_reaches_the_grouped_sum(monkeypatch):
    seen = []
    orig = grouped_mod.grouped_sum_i64

    def recording(dense, vectors, nseg):
        seen.append((dense.shape[0], len(vectors), nseg))
        return orig(dense, vectors, nseg)

    monkeypatch.setattr(grouped_mod, "grouped_sum_i64", recording)
    tcon = duckdb_tpu_torch.connect(device="cpu")
    assert tcon.sql("SELECT count(*), sum(range) FROM range(1000000)").rows() == [
        (1_000_000, 499_999_500_000)]
    assert seen and seen[0][2] == 1
