"""TPC-H Q2 to Q22 (all but Q1), a Q13 variant and a general-aggregate
query, answered with numpy alone.

An independent implementation of these queries over a directory that
testing/tpch_gen.py wrote: money in int64 cents with exact DECIMAL
scaling, joins through np.searchsorted on primary keys, groups through
np.unique(..., return_inverse=True) and np.add.at, subqueries as set
membership and per-key counts. It reads the files directly and shares no
code with the engine, so the chip's smoke run (which has no JAX) and the
CPU tests can hold the port against it.

QUERIES (joins), SUBQUERY_QUERIES, FROM_QUERIES (derived tables, OR
factoring, outer joins) and LIKE_QUERIES (LIKE, count(DISTINCT); the
oracle matches text with np.char find/startswith/endswith, not regexes)
hold the texts of DuckDB's TPC-H extension
(extension/tpch/dbgen/queries/qNN.sql) with the specification's validation
parameters (Q11's fraction is DuckDB's 0.0001000000); GENERAL_QUERIES holds
Q6, Q22 and `general_agg`, one query over lineitem with every kind of
aggregate the engine's general path computes. `q13_nolike` is Q13
with the `o_comment NOT LIKE '%special%requests%'` conjunct dropped from its
ON clause and nothing else changed. FUNCTION_QUERIES, NESTED_QUERIES and
MORE_QUERIES exercise the scalar library, nested values, and the rest of
the scalar functions with the JSON functions, each answered in numpy (and
Python's hashlib, base64 arithmetic and re where a function is a text one);
SELECT_FORM_QUERIES the set operations, grouping sets, recursion, MARK
joins and the joins without an equality, answered in numpy and Python's
collections.Counter (multisets); WINDOW_QUERIES window functions, QUALIFY
and DISTINCT ON, answered by lexsorts and per-partition cumulative sums,
shifts and searchsorted.
`answer(name, data_dir, **params)` returns the rows as `Result.rows()`
gives them (DECIMAL → decimal.Decimal, DATE → datetime.date, VARCHAR →
str), in the order ORDER BY fixes, LIMIT applied. Queries take their
substitution values as parameters (listed in `answer`), defaulting to the
specification's, since small scale factors may select nothing with them:
at SF 0.01 no supplier comment holds "Customer … Complaints" (5 in 10,000).
"""

from __future__ import annotations

import datetime
import decimal
import math
import os

import numpy as np

QUERIES = {
    "q03": """
SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue,
  o_orderdate, o_shippriority
FROM customer, orders, lineitem
WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
  AND l_orderkey = o_orderkey AND o_orderdate < CAST('1995-03-15' AS date)
  AND l_shipdate > CAST('1995-03-15' AS date)
GROUP BY l_orderkey, o_orderdate, o_shippriority
ORDER BY revenue DESC, o_orderdate
LIMIT 10
""",
    "q05": """
SELECT n_name, sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM customer, orders, lineitem, supplier, nation, region
WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
  AND l_suppkey = s_suppkey AND c_nationkey = s_nationkey
  AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
  AND r_name = 'ASIA' AND o_orderdate >= CAST('1994-01-01' AS date)
  AND o_orderdate < CAST('1995-01-01' AS date)
GROUP BY n_name
ORDER BY revenue DESC
""",
    "q10": """
SELECT c_custkey, c_name, sum(l_extendedprice * (1 - l_discount)) AS revenue,
  c_acctbal, n_name, c_address, c_phone, c_comment
FROM customer, orders, lineitem, nation
WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
  AND o_orderdate >= CAST('1993-10-01' AS date)
  AND o_orderdate < CAST('1994-01-01' AS date)
  AND l_returnflag = 'R' AND c_nationkey = n_nationkey
GROUP BY c_custkey, c_name, c_acctbal, c_phone, n_name, c_address, c_comment
ORDER BY revenue DESC
LIMIT 20
""",
    "q12": """
SELECT l_shipmode,
  sum(CASE WHEN o_orderpriority = '1-URGENT' OR o_orderpriority = '2-HIGH'
      THEN 1 ELSE 0 END) AS high_line_count,
  sum(CASE WHEN o_orderpriority <> '1-URGENT' AND o_orderpriority <> '2-HIGH'
      THEN 1 ELSE 0 END) AS low_line_count
FROM orders, lineitem
WHERE o_orderkey = l_orderkey AND l_shipmode IN ('MAIL', 'SHIP')
  AND l_commitdate < l_receiptdate AND l_shipdate < l_commitdate
  AND l_receiptdate >= CAST('1994-01-01' AS date)
  AND l_receiptdate < CAST('1995-01-01' AS date)
GROUP BY l_shipmode
ORDER BY l_shipmode
""",
}

SUBQUERY_QUERIES = {
    "q04": """
SELECT o_orderpriority, count(*) AS order_count
FROM orders
WHERE o_orderdate >= CAST('1993-07-01' AS date)
  AND o_orderdate < CAST('1993-10-01' AS date)
  AND EXISTS (SELECT * FROM lineitem
              WHERE l_orderkey = o_orderkey AND l_commitdate < l_receiptdate)
GROUP BY o_orderpriority
ORDER BY o_orderpriority
""",
    "q11": """
SELECT ps_partkey, sum(ps_supplycost * ps_availqty) AS value
FROM partsupp, supplier, nation
WHERE ps_suppkey = s_suppkey AND s_nationkey = n_nationkey AND n_name = 'GERMANY'
GROUP BY ps_partkey
HAVING sum(ps_supplycost * ps_availqty) > (
    SELECT sum(ps_supplycost * ps_availqty) * 0.0001000000
    FROM partsupp, supplier, nation
    WHERE ps_suppkey = s_suppkey AND s_nationkey = n_nationkey
      AND n_name = 'GERMANY')
ORDER BY value DESC
""",
    "q17": """
SELECT sum(l_extendedprice) / 7.0 AS avg_yearly
FROM lineitem, part
WHERE p_partkey = l_partkey AND p_brand = 'Brand#23' AND p_container = 'MED BOX'
  AND l_quantity < (SELECT 0.2 * avg(l_quantity) FROM lineitem
                    WHERE l_partkey = p_partkey)
""",
    "q18": """
SELECT c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice, sum(l_quantity)
FROM customer, orders, lineitem
WHERE o_orderkey IN (SELECT l_orderkey FROM lineitem GROUP BY l_orderkey
                     HAVING sum(l_quantity) > 300)
  AND c_custkey = o_custkey AND o_orderkey = l_orderkey
GROUP BY c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
ORDER BY o_totalprice DESC, o_orderdate
LIMIT 100
""",
    "q21": """
SELECT s_name, count(*) AS numwait
FROM supplier, lineitem l1, orders, nation
WHERE s_suppkey = l1.l_suppkey AND o_orderkey = l1.l_orderkey
  AND o_orderstatus = 'F' AND l1.l_receiptdate > l1.l_commitdate
  AND EXISTS (SELECT * FROM lineitem l2
              WHERE l2.l_orderkey = l1.l_orderkey AND l2.l_suppkey <> l1.l_suppkey)
  AND NOT EXISTS (SELECT * FROM lineitem l3
                  WHERE l3.l_orderkey = l1.l_orderkey
                    AND l3.l_suppkey <> l1.l_suppkey
                    AND l3.l_receiptdate > l3.l_commitdate)
  AND s_nationkey = n_nationkey AND n_name = 'SAUDI ARABIA'
GROUP BY s_name
ORDER BY numwait DESC, s_name
LIMIT 100
""",
}

FROM_QUERIES = {
    "q07": """
SELECT supp_nation, cust_nation, l_year, sum(volume) AS revenue
FROM (
    SELECT n1.n_name AS supp_nation, n2.n_name AS cust_nation,
        extract(year FROM l_shipdate) AS l_year,
        l_extendedprice * (1 - l_discount) AS volume
    FROM supplier, lineitem, orders, customer, nation n1, nation n2
    WHERE s_suppkey = l_suppkey AND o_orderkey = l_orderkey
        AND c_custkey = o_custkey AND s_nationkey = n1.n_nationkey
        AND c_nationkey = n2.n_nationkey
        AND ((n1.n_name = 'FRANCE' AND n2.n_name = 'GERMANY')
            OR (n1.n_name = 'GERMANY' AND n2.n_name = 'FRANCE'))
        AND l_shipdate BETWEEN CAST('1995-01-01' AS date)
            AND CAST('1996-12-31' AS date)) AS shipping
GROUP BY supp_nation, cust_nation, l_year
ORDER BY supp_nation, cust_nation, l_year
""",
    "q08": """
SELECT o_year,
    sum(CASE WHEN nation = 'BRAZIL' THEN volume ELSE 0 END) / sum(volume) AS mkt_share
FROM (
    SELECT extract(year FROM o_orderdate) AS o_year,
        l_extendedprice * (1 - l_discount) AS volume, n2.n_name AS nation
    FROM part, supplier, lineitem, orders, customer, nation n1, nation n2, region
    WHERE p_partkey = l_partkey AND s_suppkey = l_suppkey
        AND l_orderkey = o_orderkey AND o_custkey = c_custkey
        AND c_nationkey = n1.n_nationkey AND n1.n_regionkey = r_regionkey
        AND r_name = 'AMERICA' AND s_nationkey = n2.n_nationkey
        AND o_orderdate BETWEEN CAST('1995-01-01' AS date)
            AND CAST('1996-12-31' AS date)
        AND p_type = 'ECONOMY ANODIZED STEEL') AS all_nations
GROUP BY o_year
ORDER BY o_year
""",
    "q15": """
SELECT s_suppkey, s_name, s_address, s_phone, total_revenue
FROM supplier,
    (SELECT l_suppkey AS supplier_no,
         sum(l_extendedprice * (1 - l_discount)) AS total_revenue
     FROM lineitem
     WHERE l_shipdate >= CAST('1996-01-01' AS date)
         AND l_shipdate < CAST('1996-04-01' AS date)
     GROUP BY supplier_no) revenue0
WHERE s_suppkey = supplier_no
    AND total_revenue = (
        SELECT max(total_revenue)
        FROM (SELECT l_suppkey AS supplier_no,
                  sum(l_extendedprice * (1 - l_discount)) AS total_revenue
              FROM lineitem
              WHERE l_shipdate >= CAST('1996-01-01' AS date)
                  AND l_shipdate < CAST('1996-04-01' AS date)
              GROUP BY supplier_no) revenue1)
ORDER BY s_suppkey
""",
    "q19": """
SELECT sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM lineitem, part
WHERE (p_partkey = l_partkey AND p_brand = 'Brand#12'
        AND p_container IN ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
        AND l_quantity >= 1 AND l_quantity <= 1 + 10
        AND p_size BETWEEN 1 AND 5
        AND l_shipmode IN ('AIR', 'AIR REG')
        AND l_shipinstruct = 'DELIVER IN PERSON')
    OR (p_partkey = l_partkey AND p_brand = 'Brand#23'
        AND p_container IN ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
        AND l_quantity >= 10 AND l_quantity <= 10 + 10
        AND p_size BETWEEN 1 AND 10
        AND l_shipmode IN ('AIR', 'AIR REG')
        AND l_shipinstruct = 'DELIVER IN PERSON')
    OR (p_partkey = l_partkey AND p_brand = 'Brand#34'
        AND p_container IN ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
        AND l_quantity >= 20 AND l_quantity <= 20 + 10
        AND p_size BETWEEN 1 AND 15
        AND l_shipmode IN ('AIR', 'AIR REG')
        AND l_shipinstruct = 'DELIVER IN PERSON')
""",
    "q13_nolike": """
SELECT c_count, count(*) AS custdist
FROM (
    SELECT c_custkey, count(o_orderkey)
    FROM customer LEFT OUTER JOIN orders ON c_custkey = o_custkey
    GROUP BY c_custkey) AS c_orders (c_custkey, c_count)
GROUP BY c_count
ORDER BY custdist DESC, c_count DESC
""",
}

LIKE_QUERIES = {
    "q02": """
SELECT s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone, s_comment
FROM part, supplier, partsupp, nation, region
WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey AND p_size = 15
  AND p_type LIKE '%BRASS' AND s_nationkey = n_nationkey
  AND n_regionkey = r_regionkey AND r_name = 'EUROPE'
  AND ps_supplycost = (
      SELECT min(ps_supplycost)
      FROM partsupp, supplier, nation, region
      WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey
        AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
        AND r_name = 'EUROPE')
ORDER BY s_acctbal DESC, n_name, s_name, p_partkey
LIMIT 100
""",
    "q09": """
SELECT nation, o_year, sum(amount) AS sum_profit
FROM (
    SELECT n_name AS nation, extract(year FROM o_orderdate) AS o_year,
        l_extendedprice * (1 - l_discount) - ps_supplycost * l_quantity AS amount
    FROM part, supplier, lineitem, partsupp, orders, nation
    WHERE s_suppkey = l_suppkey AND ps_suppkey = l_suppkey
        AND ps_partkey = l_partkey AND p_partkey = l_partkey
        AND o_orderkey = l_orderkey AND s_nationkey = n_nationkey
        AND p_name LIKE '%green%') AS profit
GROUP BY nation, o_year
ORDER BY nation, o_year DESC
""",
    "q13": """
SELECT c_count, count(*) AS custdist
FROM (
    SELECT c_custkey, count(o_orderkey)
    FROM customer LEFT OUTER JOIN orders ON c_custkey = o_custkey
        AND o_comment NOT LIKE '%special%requests%'
    GROUP BY c_custkey) AS c_orders (c_custkey, c_count)
GROUP BY c_count
ORDER BY custdist DESC, c_count DESC
""",
    "q14": """
SELECT 100.00 * sum(CASE WHEN p_type LIKE 'PROMO%'
                         THEN l_extendedprice * (1 - l_discount) ELSE 0 END)
    / sum(l_extendedprice * (1 - l_discount)) AS promo_revenue
FROM lineitem, part
WHERE l_partkey = p_partkey AND l_shipdate >= CAST('1995-09-01' AS date)
  AND l_shipdate < CAST('1995-10-01' AS date)
""",
    "q16": """
SELECT p_brand, p_type, p_size, count(DISTINCT ps_suppkey) AS supplier_cnt
FROM partsupp, part
WHERE p_partkey = ps_partkey AND p_brand <> 'Brand#45'
  AND p_type NOT LIKE 'MEDIUM POLISHED%'
  AND p_size IN (49, 14, 23, 45, 19, 3, 36, 9)
  AND ps_suppkey NOT IN (SELECT s_suppkey FROM supplier
                         WHERE s_comment LIKE '%Customer%Complaints%')
GROUP BY p_brand, p_type, p_size
ORDER BY supplier_cnt DESC, p_brand, p_type, p_size
""",
    "q20": """
SELECT s_name, s_address
FROM supplier, nation
WHERE s_suppkey IN (
        SELECT ps_suppkey FROM partsupp
        WHERE ps_partkey IN (SELECT p_partkey FROM part WHERE p_name LIKE 'forest%')
          AND ps_availqty > (
              SELECT 0.5 * sum(l_quantity) FROM lineitem
              WHERE l_partkey = ps_partkey AND l_suppkey = ps_suppkey
                AND l_shipdate >= CAST('1994-01-01' AS date)
                AND l_shipdate < CAST('1995-01-01' AS date)))
  AND s_nationkey = n_nationkey AND n_name = 'CANADA'
ORDER BY s_name
""",
}

# the general-aggregate slice: Q6 (fused, one slot), Q22 (a computed VARCHAR
# group key, so the general path) and GENERAL_AGGREGATE, which runs every
# kind of aggregate the general path adds over lineitem
GENERAL_QUERIES = {
    "q06": """
SELECT sum(l_extendedprice * l_discount) AS revenue
FROM lineitem
WHERE l_shipdate >= CAST('1994-01-01' AS date)
  AND l_shipdate < CAST('1995-01-01' AS date)
  AND l_discount BETWEEN 0.05 AND 0.07
  AND l_quantity < 24
""",
    "q22": """
SELECT cntrycode, count(*) AS numcust, sum(c_acctbal) AS totacctbal
FROM (
    SELECT substring(c_phone FROM 1 FOR 2) AS cntrycode, c_acctbal
    FROM customer
    WHERE substring(c_phone FROM 1 FOR 2) IN ('13', '31', '23', '29', '30', '18', '17')
      AND c_acctbal > (
          SELECT avg(c_acctbal) FROM customer
          WHERE c_acctbal > 0.00
            AND substring(c_phone FROM 1 FOR 2) IN ('13', '31', '23', '29', '30', '18', '17'))
      AND NOT EXISTS (SELECT * FROM orders WHERE o_custkey = c_custkey)) AS custsale
GROUP BY cntrycode
ORDER BY cntrycode
""",
    "general_agg": """
SELECT l_returnflag, l_linestatus,
  stddev_samp(l_quantity) AS sd_qty, var_pop(l_extendedprice) AS var_price,
  median(l_quantity) AS med_qty, quantile_disc(l_extendedprice, 0.9) AS p90_price,
  mode(l_shipmode) AS top_mode,
  first(l_orderkey ORDER BY l_extendedprice DESC) AS top_order,
  arg_max(l_partkey, l_quantity) AS big_part, bool_or(l_quantity > 49) AS any_full,
  product(1 + l_discount) FILTER (WHERE l_orderkey < 1000) AS growth,
  count(*) FILTER (WHERE l_discount > 0.05) AS n_disc,
  min(l_shipinstruct) AS first_instr, max(l_comment) AS last_comment,
  corr(l_quantity, l_extendedprice) AS corr_qp
FROM lineitem
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
""",
}

# function-heavy queries over the TPC-H tables: dates, math with DuckDB's
# truncating % and //, the bit aggregates and HyperLogLog, the string plane
# functions, and the formatting casts (strftime, TIMESTAMP → VARCHAR)
FUNCTION_QUERIES = {
    "fn_dates": """
SELECT date_trunc('year', l_shipdate) AS yr, count(*), sum(l_quantity),
  sum(date_diff('day', l_shipdate, l_receiptdate)), max(last_day(l_shipdate)),
  min(dayname(l_commitdate)),
  sum(CASE WHEN isodow(l_receiptdate) >= 6 THEN 1 ELSE 0 END)
FROM lineitem GROUP BY yr ORDER BY yr
""",
    "fn_math": """
SELECT l_returnflag, l_linestatus, sum(CAST(l_quantity AS INTEGER) % 7),
  sum(-l_linenumber // 2), sum(greatest(l_tax, l_discount)),
  count(nullif(l_linenumber, 1)), sum(if(l_shipmode = 'AIR', 1, 0)),
  sum(gcd(l_orderkey, l_linenumber)), bit_xor(l_orderkey), bit_or(l_suppkey),
  bit_and(l_partkey + 1048576), bit_xor(hash(l_orderkey)),
  approx_count_distinct(l_partkey), avg(ln(l_extendedprice)), geomean(l_quantity)
FROM lineitem GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus
""",
    "fn_strings": """
SELECT left(p_name, 5) AS k, count(*), sum(strpos(p_name, 'green')),
  max(initcap(reverse(p_name))), min(lpad(p_brand, 12, '*')),
  sum(ascii(right(p_name, 4)))
FROM part GROUP BY k ORDER BY 2 DESC, 1 LIMIT 20
""",
    "fn_casts": """
SELECT strftime(o_orderdate, '%Y-%m') AS ym, count(*), sum(o_totalprice),
  max(CAST(CAST(o_orderdate AS TIMESTAMP) AS VARCHAR)),
  sum(strpos(o_comment, 'special')), sum(ascii(o_comment))
FROM orders GROUP BY ym ORDER BY ym
""",
}

# nested values: the nested-result aggregates, per-order lists with
# lambdas, UNNEST and a columnar list_value, string_agg with ORDER BY
NESTED_QUERIES = {
    "nested_agg": """
SELECT l_returnflag, l_linestatus,
  histogram(l_shipmode), histogram(l_shipmode)['AIR'],
  cardinality(histogram(l_shipmode)),
  approx_top_k(l_shipmode, 2), list(DISTINCT l_shipinstruct),
  bitstring_agg(l_linenumber), count(*), sum(l_quantity)
FROM lineitem GROUP BY 1, 2 ORDER BY 1, 2
""",
    "nested_collect": """
SELECT len(s) AS n, count(*) AS orders,
  sum(list_sort(s)[1]) AS firsts,
  sum(list_reduce(s, lambda a, x: a + x)) AS total,
  sum(len(list_filter(s, x -> x % 2 = 0))) AS evens
FROM (SELECT l_orderkey, list(l_partkey ORDER BY l_linenumber) AS s
      FROM lineitem GROUP BY l_orderkey)
GROUP BY 1 ORDER BY 1
""",
    "nested_words": """
SELECT w, count(*) AS n
FROM (SELECT unnest(string_split(p_name, ' ')) AS w FROM part)
GROUP BY w ORDER BY n DESC, w LIMIT 10
""",
    "nested_pack": """
SELECT p_size, count(*) AS n, sum(l[1]) AS keys,
  sum(CAST(list_contains(string_split(p_name, ' '), 'green') AS INTEGER)) AS green,
  min(string_split(p_name, ' ')[2]) AS w2
FROM (SELECT p_size, p_name, list_value(p_partkey, p_size) AS l FROM part)
GROUP BY p_size ORDER BY p_size
""",
    "nested_pack_agg": """
SELECT s_nationkey, count(*),
  string_agg(s_name, ',' ORDER BY s_acctbal DESC, s_name)
FROM supplier GROUP BY 1 ORDER BY 1
""",
}

# the rest of the scalar library: functions_more's dates, math and text
# functions, functions_parity's list functions over a columnar list, and
# the JSON functions
MORE_QUERIES = {
    "more_dates": """
SELECT o_orderstatus, count(*), sum(isoyear(o_orderdate)), sum(yearweek(o_orderdate)),
  sum(epoch_ms(o_orderdate::TIMESTAMP) // 86400000),
  sum(date_sub('day', DATE '1992-01-01', o_orderdate)),
  max(make_timestamp(year(o_orderdate), 1, 1, 0, 0, 0.0)),
  sum(millennium(o_orderdate)), sum(julian(o_orderdate))
FROM orders GROUP BY 1 ORDER BY 1
""",
    "more_math": """
SELECT l_returnflag, l_linestatus, sum(acosh(l_quantity + 1)), sum(asinh(l_extendedprice)),
  sum(signbit(l_tax - 0.04)::INT), sum(cot(l_discount + 0.5)), count(*)
FROM lineitem GROUP BY 1, 2 ORDER BY 1, 2
""",
    "more_text": """
SELECT p_mfgr, sum(bit_length(p_name)), sum(length(to_base64(p_name::BLOB))),
  max(sha256(p_name)), sum(jaccard(p_name, 'almond')),
  sum(damerau_levenshtein(p_container, 'JUMBO PKG')), count(DISTINCT md5_number(p_type)),
  max(regexp_extract_all(p_name, '[a-z]+')[2]), max(parse_filename(p_type))
FROM part GROUP BY 1 ORDER BY 1
""",
    "parity_lists": """
SELECT p_size % 5 AS k, sum(list_dot_product(v, [1, 2])), max(list_distance(v, [10, 3])),
  sum(len(list_zip(v, v))), max(list_grade_up(v)), sum(list_resize(v, 3, 0)[3])
FROM (SELECT p_size, list_value(p_size, p_partkey % 7) AS v FROM part)
GROUP BY 1 ORDER BY 1
""",
    "json_orders": """
SELECT json_extract_string(j, '$.b') AS b, count(*), sum(json_extract(j, '$.a')::INT)
FROM (SELECT json_object('a', o_orderkey % 10, 'b', o_orderpriority) AS j FROM orders)
GROUP BY 1 ORDER BY 1
""",
}

# slice 11's SELECT forms: set operations, VALUES, GROUPING SETS, WITH
# RECURSIVE, MARK joins, NOT IN with a residual and the joins without an
# equality (ASOF, inequality, cross, POSITIONAL, USING, NATURAL); each has
# a numpy answer below (the samples and the catalog functions are checked
# by their callers: a count within bounds, the generator's own schema)
_SHIP_WINDOW = ("l_shipdate >= DATE '1995-01-01' AND l_shipdate < DATE '1995-03-01'")
_SETOP_LEFT = f"SELECT l_partkey AS k FROM lineitem WHERE {_SHIP_WINDOW}"
_SETOP_RIGHT = "SELECT p_partkey FROM part WHERE p_size < 20"
SELECT_FORM_QUERIES = {
    "rollup_q1": """
SELECT l_returnflag, l_linestatus, grouping(l_returnflag) AS g,
  sum(l_quantity) AS sum_qty, sum(l_extendedprice) AS sum_base_price,
  sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
  sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
  avg(l_quantity) AS avg_qty, avg(l_extendedprice) AS avg_price,
  avg(l_discount) AS avg_disc, count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= CAST('1998-09-02' AS date)
GROUP BY ROLLUP (l_returnflag, l_linestatus)
ORDER BY l_returnflag NULLS LAST, l_linestatus NULLS LAST
""",
    "cube_flags": """
SELECT l_returnflag, l_linestatus, count(*), sum(l_quantity)
FROM lineitem GROUP BY CUBE (l_returnflag, l_linestatus)
ORDER BY 1 NULLS LAST, 2 NULLS LAST
""",
    "setops_big": """
SELECT count(*), sum(x) FROM (SELECT l_quantity AS x FROM lineitem
  UNION ALL SELECT ps_availqty FROM partsupp)
""",
    "setops_intersect": f"SELECT count(*), sum(k) FROM ({_SETOP_LEFT} INTERSECT {_SETOP_RIGHT})",
    "setops_except": f"SELECT count(*), sum(k) FROM ({_SETOP_LEFT} EXCEPT {_SETOP_RIGHT})",
    "setops_intersect_all":
        f"SELECT count(*), sum(k) FROM ({_SETOP_LEFT} INTERSECT ALL {_SETOP_RIGHT})",
    "setops_except_all":
        f"SELECT count(*), sum(k) FROM ({_SETOP_LEFT} EXCEPT ALL {_SETOP_RIGHT})",
    "values_join": """
SELECT v.label, count(*), sum(s_acctbal)
FROM supplier, (VALUES """ + ", ".join(f"({k}, '{['west', 'east', 'north', 'south'][k % 4]}')"
                                        for k in range(25)) + """) v(k, label)
WHERE s_nationkey = v.k
GROUP BY v.label ORDER BY v.label
""",
    "recursive_months": """
WITH RECURSIVE months(ym) AS (
  SELECT 1992 * 12 + 1 UNION ALL SELECT ym + 1 FROM months WHERE ym < 1998 * 12 + 12)
SELECT ym, count(*) FROM months, orders
WHERE year(o_orderdate) * 12 + month(o_orderdate) = ym
GROUP BY ym ORDER BY ym
""",
    "mark_q4": """
SELECT o_orderpriority,
  sum(CASE WHEN EXISTS (SELECT * FROM lineitem WHERE l_orderkey = o_orderkey
                         AND l_commitdate < l_receiptdate) THEN 1 ELSE 0 END) AS order_count
FROM orders
WHERE o_orderdate >= CAST('1993-07-01' AS date) AND o_orderdate < CAST('1993-10-01' AS date)
GROUP BY o_orderpriority ORDER BY o_orderpriority
""",
    "mark_in_or": """
SELECT o_orderstatus, count(*), sum(o_totalprice) FROM orders
WHERE o_custkey IN (SELECT c_custkey FROM customer WHERE c_mktsegment = 'BUILDING')
   OR o_totalprice > 400000
GROUP BY o_orderstatus ORDER BY o_orderstatus
""",
    "notin_residual": """
SELECT count(*), sum(l_quantity) FROM lineitem
WHERE l_suppkey NOT IN (SELECT ps_suppkey FROM partsupp
                        WHERE ps_partkey = l_partkey AND ps_availqty > l_quantity * 100)
""",
    "asof_ship": """
SELECT count(*), sum(o_totalprice) FROM lineitem l
ASOF JOIN orders o ON l_orderkey = o_orderkey AND l_shipdate >= o_orderdate
""",
    "band_join": """
SELECT count(*) FROM part, supplier
WHERE p_retailprice BETWEEN s_acctbal - 1 AND s_acctbal + 1
""",
    "cross_small": """
SELECT r_name, count(*), sum(n_nationkey) FROM nation, region GROUP BY r_name ORDER BY r_name
""",
    "positional": """
SELECT count(*), sum(a), sum(b), sum(a * b)
FROM (SELECT l_quantity AS a FROM lineitem WHERE l_linenumber = 1)
POSITIONAL JOIN (SELECT l_discount AS b FROM lineitem WHERE l_returnflag = 'R')
""",
    "using_left": """
SELECT count(*), count(c_name), sum(c_custkey) FROM
  (SELECT o_orderkey, o_custkey AS c_custkey FROM orders WHERE o_orderkey % 7 = 0) o
  LEFT JOIN (SELECT c_custkey, c_name FROM customer WHERE c_nationkey < 10) c
  USING (c_custkey)
""",
    "using_full": """
SELECT count(*), count(c_custkey), sum(c_custkey), count(o_orderkey), count(c_name) FROM
  (SELECT o_orderkey, o_custkey AS c_custkey FROM orders WHERE o_orderkey % 7 = 0) o
  FULL JOIN (SELECT c_custkey, c_name FROM customer WHERE c_nationkey < 10) c
  USING (c_custkey)
""",
    "natural_join": """
SELECT count(*), sum(c_custkey), sum(o_totalprice) FROM
  (SELECT o_custkey AS c_custkey, o_orderstatus AS st, o_totalprice FROM orders) o
  NATURAL JOIN (SELECT c_custkey, 'F' AS st FROM customer WHERE c_mktsegment = 'MACHINERY') c
""",
    "sample_rows": "SELECT count(*) FROM lineitem USING SAMPLE 100000 ROWS (reservoir, 42)",
}
SAMPLE_PERCENT_QUERY = "SELECT count(*) FROM lineitem TABLESAMPLE 10% REPEATABLE (42)"

_SUPP_ORDER = "PARTITION BY l_suppkey ORDER BY l_shipdate, l_orderkey, l_linenumber"
_PS_ORDER = "PARTITION BY ps_partkey ORDER BY ps_supplycost"
WINDOW_QUERIES = {
    "win_rank_lineitem": """
SELECT l_returnflag, l_linestatus, count(*) AS n, sum(l_extendedprice) AS s
FROM (SELECT l_returnflag, l_linestatus, l_extendedprice,
        rank() OVER (PARTITION BY l_orderkey ORDER BY l_extendedprice DESC) AS r
      FROM lineitem) t
WHERE r = 1
GROUP BY l_returnflag, l_linestatus ORDER BY 1, 2
""",
    "win_running_orders": """
SELECT o_orderpriority, count(*) AS n, max(rs) AS top, sum(rs) AS s
FROM (SELECT o_orderpriority, sum(o_totalprice) OVER (PARTITION BY o_orderpriority
        ORDER BY o_orderdate, o_orderkey ROWS UNBOUNDED PRECEDING) AS rs
      FROM orders) t
GROUP BY o_orderpriority ORDER BY 1
""",
    "win_frames_lineitem": f"""
SELECT l_returnflag, count(*) AS n, sum(a7) AS s_a7, sum(mn) AS s_mn, sum(mx) AS s_mx,
  sum(r30) AS s_r30
FROM (SELECT l_returnflag,
        avg(l_quantity) OVER ({_SUPP_ORDER} ROWS BETWEEN 6 PRECEDING AND CURRENT ROW) AS a7,
        min(l_extendedprice) OVER ({_SUPP_ORDER}
          ROWS BETWEEN 3 PRECEDING AND 3 FOLLOWING) AS mn,
        max(l_extendedprice) OVER ({_SUPP_ORDER}
          ROWS BETWEEN 3 PRECEDING AND 3 FOLLOWING) AS mx,
        sum(l_quantity) OVER (PARTITION BY l_suppkey ORDER BY l_shipdate
          RANGE BETWEEN INTERVAL 30 DAY PRECEDING AND CURRENT ROW) AS r30
      FROM lineitem) t
GROUP BY l_returnflag ORDER BY 1
""",
    "win_lag_lead": """
SELECT count(*) AS n, count(prev_ship) AS n_prev, count(next_ship) AS n_next,
  sum(CASE WHEN l_shipdate < prev_ship THEN 1 ELSE 0 END) AS n_earlier
FROM (SELECT l_shipdate,
        lag(l_shipdate) OVER (PARTITION BY l_orderkey ORDER BY l_linenumber) AS prev_ship,
        lead(l_shipdate) OVER (PARTITION BY l_orderkey ORDER BY l_linenumber) AS next_ship
      FROM lineitem) t
""",
    "win_dist_partsupp": f"""
SELECT n4, count(*) AS n, sum(pr) AS s_pr, sum(cd) AS s_cd, sum(dr) AS s_dr
FROM (SELECT ntile(4) OVER ({_PS_ORDER}) AS n4, percent_rank() OVER ({_PS_ORDER}) AS pr,
        cume_dist() OVER ({_PS_ORDER}) AS cd, dense_rank() OVER ({_PS_ORDER}) AS dr
      FROM partsupp) t
GROUP BY n4 ORDER BY n4
""",
    "win_median_part": """
SELECT p_brand, count(*) AS n, min(m) AS m
FROM (SELECT p_brand, median(p_retailprice) OVER (PARTITION BY p_brand) AS m FROM part) t
GROUP BY p_brand ORDER BY p_brand
""",
    "qualify_top3": """
SELECT c_nationkey, c_custkey, c_acctbal,
  row_number() OVER (PARTITION BY c_nationkey ORDER BY c_acctbal DESC, c_custkey) AS rn
FROM customer QUALIFY rn <= 3 ORDER BY c_nationkey, rn
""",
    "distinct_on_nation": """
SELECT DISTINCT ON (c_nationkey) c_nationkey, c_custkey, c_name, c_acctbal
FROM customer ORDER BY c_nationkey, c_acctbal DESC
""",
}

_EPOCH = datetime.date(1970, 1, 1)


def _day(text: str) -> int:
    return (datetime.date.fromisoformat(text) - _EPOCH).days


def _date(days) -> datetime.date:
    return _EPOCH + datetime.timedelta(days=int(days))


def _dec(cents, scale: int) -> decimal.Decimal:
    return decimal.Decimal(int(cents)).scaleb(-scale)


class _Tables:
    """Lazy column reader over a generated directory."""

    def __init__(self, data_dir: str):
        self.dir = data_dir
        self._cache = {}

    def __call__(self, table: str, col: str) -> np.ndarray:
        key = (table, col)
        if key not in self._cache:
            base = os.path.join(self.dir, table, col)
            if os.path.exists(base + ".i64"):
                v = np.fromfile(base + ".i64", dtype=np.int64)
            elif os.path.exists(base + ".i32"):
                v = np.fromfile(base + ".i32", dtype=np.int32).astype(np.int64)
            else:  # VARCHAR → fixed-width bytes
                lens = np.fromfile(base + ".len", dtype=np.uint32).astype(np.int64)
                blob = np.fromfile(base + ".bytes", dtype=np.uint8)
                width = max(1, int(lens.max()) if len(lens) else 1)
                starts = np.cumsum(lens) - lens
                pos = starts[:, None] + np.arange(width)[None, :]
                keep = np.arange(width)[None, :] < lens[:, None]
                mat = np.where(keep, blob[np.minimum(pos, max(len(blob) - 1, 0))], 0)
                v = mat.astype(np.uint8).view(f"S{width}").reshape(len(lens))
            self._cache[key] = v
        return self._cache[key]


def _lookup(keys: np.ndarray, probe: np.ndarray) -> np.ndarray:
    """Row of each probe value in the sorted unique `keys` (-1 when absent)."""
    pos = np.clip(np.searchsorted(keys, probe), 0, len(keys) - 1)
    return np.where(keys[pos] == probe, pos, -1)


def _group_sum(keys, values):
    """→ (unique key tuples' row representatives, per-group int64 sums)."""
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    sums = np.zeros(len(uniq), dtype=np.int64)
    np.add.at(sums, inv.reshape(-1), values)
    return uniq, sums


def _revenue(t, rows):
    return t("lineitem", "l_extendedprice")[rows] * (100 - t("lineitem", "l_discount")[rows])


def q03(t):
    cust_ok = t("customer", "c_mktsegment") == b"BUILDING"
    ckey = t("customer", "c_custkey")
    crow = _lookup(ckey, t("orders", "o_custkey"))
    o_ok = (t("orders", "o_orderdate") < _day("1995-03-15")) & (crow >= 0) & cust_ok[crow]
    orow = _lookup(t("orders", "o_orderkey"), t("lineitem", "l_orderkey"))
    l_ok = (t("lineitem", "l_shipdate") > _day("1995-03-15")) & (orow >= 0) & o_ok[orow]
    rows = np.flatnonzero(l_ok)
    orows, sums = _group_sum(orow[rows], _revenue(t, rows))
    odate = t("orders", "o_orderdate")[orows]
    order = np.lexsort((odate, -sums))[:10]
    return [(int(t("orders", "o_orderkey")[r]), _dec(s, 4), _date(d),
             int(t("orders", "o_shippriority")[r]))
            for r, s, d in zip(orows[order], sums[order], odate[order])]


def q05(t):
    r_ok = t("region", "r_name") == b"ASIA"
    n_reg = _lookup(t("region", "r_regionkey"), t("nation", "n_regionkey"))
    n_ok = (n_reg >= 0) & r_ok[n_reg]
    orow = _lookup(t("orders", "o_orderkey"), t("lineitem", "l_orderkey"))
    odate = t("orders", "o_orderdate")
    o_ok = (odate >= _day("1994-01-01")) & (odate < _day("1995-01-01"))
    crow = _lookup(t("customer", "c_custkey"), t("orders", "o_custkey"))
    srow = _lookup(t("supplier", "s_suppkey"), t("lineitem", "l_suppkey"))
    s_nat = t("supplier", "s_nationkey")[srow]
    c_nat = t("customer", "c_nationkey")[crow[orow]]
    nrow = _lookup(t("nation", "n_nationkey"), s_nat)
    ok = ((orow >= 0) & o_ok[orow] & (crow[orow] >= 0) & (srow >= 0)
          & (c_nat == s_nat) & (nrow >= 0) & n_ok[nrow])
    rows = np.flatnonzero(ok)
    nrows, sums = _group_sum(nrow[rows], _revenue(t, rows))
    names = t("nation", "n_name")[nrows]
    order = np.lexsort((names, -sums))  # ties in revenue: any order is valid
    return [(names[i].decode(), _dec(sums[i], 4)) for i in order]


def q10(t):
    odate = t("orders", "o_orderdate")
    o_ok = (odate >= _day("1993-10-01")) & (odate < _day("1994-01-01"))
    orow = _lookup(t("orders", "o_orderkey"), t("lineitem", "l_orderkey"))
    crow = _lookup(t("customer", "c_custkey"), t("orders", "o_custkey"))
    c_nrow = _lookup(t("nation", "n_nationkey"), t("customer", "c_nationkey"))
    lcrow = crow[orow]
    ok = ((orow >= 0) & o_ok[orow] & (t("lineitem", "l_returnflag") == b"R")
          & (lcrow >= 0) & (c_nrow[lcrow] >= 0))
    rows = np.flatnonzero(ok)
    # the group key is the customer row (the other six columns depend on it)
    crows, sums = _group_sum(lcrow[rows], _revenue(t, rows))
    order = np.lexsort((t("customer", "c_custkey")[crows], -sums))[:20]
    out = []
    for r, s in zip(crows[order], sums[order]):
        out.append((int(t("customer", "c_custkey")[r]),
                    t("customer", "c_name")[r].decode(), _dec(s, 4),
                    _dec(t("customer", "c_acctbal")[r], 2),
                    t("nation", "n_name")[c_nrow[r]].decode(),
                    t("customer", "c_address")[r].decode(),
                    t("customer", "c_phone")[r].decode(),
                    t("customer", "c_comment")[r].decode()))
    return out


def q12(t):
    mode = t("lineitem", "l_shipmode")
    ship, commit, receipt = (t("lineitem", c) for c in
                             ("l_shipdate", "l_commitdate", "l_receiptdate"))
    orow = _lookup(t("orders", "o_orderkey"), t("lineitem", "l_orderkey"))
    ok = (((mode == b"MAIL") | (mode == b"SHIP")) & (commit < receipt)
          & (ship < commit) & (receipt >= _day("1994-01-01"))
          & (receipt < _day("1995-01-01")) & (orow >= 0))
    rows = np.flatnonzero(ok)
    prio = t("orders", "o_orderpriority")[orow[rows]]
    high = ((prio == b"1-URGENT") | (prio == b"2-HIGH")).astype(np.int64)
    modes, highs = _group_sum(mode[rows], high)
    _, lows = _group_sum(mode[rows], 1 - high)
    return [(m.decode(), int(h), int(lo)) for m, h, lo in zip(modes, highs, lows)]


def _counts_per_row(keys: np.ndarray) -> np.ndarray:
    """For each row, how many rows share its key."""
    _, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
    return counts[inv.reshape(-1)]


def _nation_rows(t, table: str, prefix: str, name: bytes) -> np.ndarray:
    """Mask of `table`'s rows whose nation is called `name`."""
    nrow = _lookup(t("nation", "n_nationkey"), t(table, f"{prefix}_nationkey"))
    return (nrow >= 0) & (t("nation", "n_name")[nrow] == name)


def q04(t):
    late = t("lineitem", "l_commitdate") < t("lineitem", "l_receiptdate")
    has_late = np.isin(t("orders", "o_orderkey"), t("lineitem", "l_orderkey")[late])
    odate = t("orders", "o_orderdate")
    ok = (odate >= _day("1993-07-01")) & (odate < _day("1993-10-01")) & has_late
    prios, counts = np.unique(t("orders", "o_orderpriority")[ok], return_counts=True)
    return [(p.decode(), int(c)) for p, c in zip(prios, counts)]


def q11(t, nation: str = "GERMANY"):
    srow = _lookup(t("supplier", "s_suppkey"), t("partsupp", "ps_suppkey"))
    ok = (srow >= 0) & _nation_rows(t, "supplier", "s", nation.encode())[srow]
    rows = np.flatnonzero(ok)
    value = t("partsupp", "ps_supplycost")[rows] * t("partsupp", "ps_availqty")[rows]
    parts, sums = _group_sum(t("partsupp", "ps_partkey")[rows], value)
    # sum (scale 2) > total (scale 2) × 0.0001000000, exactly
    keep = sums.astype(object) * 10_000 > int(value.astype(object).sum())
    parts, sums = parts[keep], sums[keep]
    order = np.lexsort((parts, -sums))  # ties in value: any order is valid
    return [(int(parts[i]), _dec(sums[i], 2)) for i in order]


def q17(t):
    part_ok = ((t("part", "p_brand") == b"Brand#23")
               & (t("part", "p_container") == b"MED BOX"))
    lpart = t("lineitem", "l_partkey")
    prow = _lookup(t("part", "p_partkey"), lpart)
    qty = t("lineitem", "l_quantity")
    # 0.2 * avg(l_quantity) over each part's lines, in float64 as avg is
    parts, inv = np.unique(lpart, return_inverse=True)
    inv = inv.reshape(-1)
    qsum = np.zeros(len(parts), dtype=np.int64)
    np.add.at(qsum, inv, qty)
    cnt = np.bincount(inv, minlength=len(parts))
    avg = qsum.astype(np.float64) / (cnt.astype(np.float64) * 100.0)
    ok = (prow >= 0) & part_ok[prow] & (qty.astype(np.float64) / 100.0 < 0.2 * avg[inv])
    if not ok.any():
        return [(None,)]
    total = int(t("lineitem", "l_extendedprice")[ok].sum())
    return [(float(total) / 100.0 / 7.0,)]


def q18(t, threshold: int = 300):
    lkey, qty = t("lineitem", "l_orderkey"), t("lineitem", "l_quantity")
    keys, qsums = _group_sum(lkey, qty)
    big = qsums > threshold * 100
    orow = _lookup(t("orders", "o_orderkey"), keys[big])
    crow = _lookup(t("customer", "c_custkey"), t("orders", "o_custkey")[orow])
    keep = (orow >= 0) & (crow >= 0)
    orow, crow = orow[keep], crow[keep]
    qsum = qsums[big][keep]
    price, odate = t("orders", "o_totalprice")[orow], t("orders", "o_orderdate")[orow]
    order = np.lexsort((odate, -price))[:100]
    return [(t("customer", "c_name")[crow[i]].decode(), int(t("customer", "c_custkey")[crow[i]]),
             int(t("orders", "o_orderkey")[orow[i]]), _date(odate[i]), _dec(price[i], 2),
             _dec(qsum[i], 2)) for i in order]


def q21(t):
    """EXISTS / NOT EXISTS as counts: a line of the same order from another
    supplier exists iff the order has more lines than lines of this
    supplier (among the late lines for NOT EXISTS)."""
    lkey, supp = t("lineitem", "l_orderkey"), t("lineitem", "l_suppkey")
    late = t("lineitem", "l_receiptdate") > t("lineitem", "l_commitdate")
    pair = lkey * (int(supp.max()) + 1) + supp
    others = _counts_per_row(lkey) - _counts_per_row(pair)
    late_keys, late_pairs = lkey[late], pair[late]
    uk, kc = np.unique(late_keys, return_counts=True)
    up, pc = np.unique(late_pairs, return_counts=True)

    def count_in(u, c, probe):
        pos = _lookup(u, probe)
        return np.where(pos >= 0, c[np.maximum(pos, 0)], 0)

    late_others = count_in(uk, kc, lkey) - count_in(up, pc, pair)
    orow = _lookup(t("orders", "o_orderkey"), lkey)
    srow = _lookup(t("supplier", "s_suppkey"), supp)
    ok = (late & (orow >= 0) & (t("orders", "o_orderstatus")[orow] == b"F")
          & (srow >= 0) & _nation_rows(t, "supplier", "s", b"SAUDI ARABIA")[srow]
          & (others > 0) & (late_others == 0))
    names, counts = np.unique(t("supplier", "s_name")[srow[ok]], return_counts=True)
    order = np.lexsort((names, -counts))[:100]
    return [(names[i].decode(), int(counts[i])) for i in order]


def _year(days: np.ndarray) -> np.ndarray:
    return days.astype("datetime64[D]").astype("datetime64[Y]").astype(np.int64) + 1970


def _nation_name(t, nationkey: np.ndarray) -> np.ndarray:
    return t("nation", "n_name")[_lookup(t("nation", "n_nationkey"), nationkey)]


def q07(t, nation1: str = "FRANCE", nation2: str = "GERMANY"):
    ship = t("lineitem", "l_shipdate")
    srow = _lookup(t("supplier", "s_suppkey"), t("lineitem", "l_suppkey"))
    orow = _lookup(t("orders", "o_orderkey"), t("lineitem", "l_orderkey"))
    crow = _lookup(t("customer", "c_custkey"), t("orders", "o_custkey"))[orow]
    supp_nat = _nation_name(t, t("supplier", "s_nationkey")[srow])
    cust_nat = _nation_name(t, t("customer", "c_nationkey")[crow])
    a, b = nation1.encode(), nation2.encode()
    ok = ((ship >= _day("1995-01-01")) & (ship <= _day("1996-12-31"))
          & (srow >= 0) & (orow >= 0) & (crow >= 0)
          & (((supp_nat == a) & (cust_nat == b)) | ((supp_nat == b) & (cust_nat == a))))
    rows = np.flatnonzero(ok)
    groups = {}
    for s_n, c_n, y, v in zip(supp_nat[rows], cust_nat[rows], _year(ship[rows]),
                              _revenue(t, rows)):
        key = (s_n.decode(), c_n.decode(), int(y))
        groups[key] = groups.get(key, 0) + int(v)
    return [k + (_dec(groups[k], 4),) for k in sorted(groups)]


def q08(t, nation: str = "BRAZIL", region: str = "AMERICA",
        ptype: str = "ECONOMY ANODIZED STEEL"):
    odate = t("orders", "o_orderdate")
    prow = _lookup(t("part", "p_partkey"), t("lineitem", "l_partkey"))
    srow = _lookup(t("supplier", "s_suppkey"), t("lineitem", "l_suppkey"))
    orow = _lookup(t("orders", "o_orderkey"), t("lineitem", "l_orderkey"))
    crow = _lookup(t("customer", "c_custkey"), t("orders", "o_custkey"))[orow]
    c_nrow = _lookup(t("nation", "n_nationkey"), t("customer", "c_nationkey")[crow])
    rrow = _lookup(t("region", "r_regionkey"), t("nation", "n_regionkey")[c_nrow])
    ldate = odate[orow]
    ok = ((prow >= 0) & (srow >= 0) & (orow >= 0) & (crow >= 0) & (c_nrow >= 0)
          & (rrow >= 0) & (t("region", "r_name")[rrow] == region.encode())
          & (t("part", "p_type")[prow] == ptype.encode())
          & (ldate >= _day("1995-01-01")) & (ldate <= _day("1996-12-31")))
    rows = np.flatnonzero(ok)
    years = _year(ldate[rows])
    volume = _revenue(t, rows)
    mine = _nation_name(t, t("supplier", "s_nationkey")[srow[rows]]) == nation.encode()
    out = []
    for y in np.unique(years):
        sel = years == y
        share = int(volume[sel & mine].sum()), int(volume[sel].sum())
        # DECIMAL / DECIMAL binds DOUBLE: each sum as a double, then divided
        out.append((int(y), (share[0] / 10_000) / (share[1] / 10_000)))
    return out


def q15(t):
    ship = t("lineitem", "l_shipdate")
    ok = (ship >= _day("1996-01-01")) & (ship < _day("1996-04-01"))
    rows = np.flatnonzero(ok)
    supp, revenue = _group_sum(t("lineitem", "l_suppkey")[rows], _revenue(t, rows))
    best = supp[revenue == revenue.max()] if len(supp) else supp
    out = []
    for key in np.sort(best):
        r = _lookup(t("supplier", "s_suppkey"), np.array([key]))[0]
        if r >= 0:
            out.append((int(key), t("supplier", "s_name")[r].decode(),
                        t("supplier", "s_address")[r].decode(),
                        t("supplier", "s_phone")[r].decode(), _dec(revenue.max(), 4)))
    return out


# (brand, containers, least quantity, largest size) of Q19's three branches
_Q19_BRANCHES = (
    ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 5),
    ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10, 10),
    ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20, 15))


def q19(t):
    prow = _lookup(t("part", "p_partkey"), t("lineitem", "l_partkey"))
    qty = t("lineitem", "l_quantity")
    mode = t("lineitem", "l_shipmode")
    brand = t("part", "p_brand")[prow]
    container = t("part", "p_container")[prow]
    size = t("part", "p_size")[prow]
    ok = np.zeros(len(qty), dtype=bool)
    for b, boxes, q, top in _Q19_BRANCHES:
        ok |= ((brand == b.encode()) & np.isin(container, [x.encode() for x in boxes])
               & (qty >= q * 100) & (qty <= (q + 10) * 100) & (size >= 1) & (size <= top))
    ok &= ((prow >= 0) & ((mode == b"AIR") | (mode == b"AIR REG"))
           & (t("lineitem", "l_shipinstruct") == b"DELIVER IN PERSON"))
    if not ok.any():
        return [(None,)]
    return [(_dec(int(_revenue(t, np.flatnonzero(ok)).sum()), 4),)]


def q13_nolike(t):
    """Orders per customer (zero for a customer with none), then customers
    per order count."""
    crow = _lookup(t("customer", "c_custkey"), t("orders", "o_custkey"))
    per_cust = np.bincount(crow[crow >= 0], minlength=len(t("customer", "c_custkey")))
    counts, dist = np.unique(per_cust, return_counts=True)
    order = np.lexsort((-counts, -dist))
    return [(int(counts[i]), int(dist[i])) for i in order]


def _has_in_order(values: np.ndarray, words) -> np.ndarray:
    """Rows of a bytes column that hold words[0], then words[1] after it, …
    (LIKE '%w0%w1%…%'): the leftmost hit of each word leaves the most room
    for the next."""
    start = np.zeros(len(values), dtype=np.int64)
    ok = np.ones(len(values), dtype=bool)
    for w in words:
        at = np.char.find(values, w.encode(), np.where(ok, start, 0))
        ok &= at >= 0
        start = at + len(w)
    return ok


def _region_supplier(t, region: str) -> np.ndarray:
    """Per supplier row: its nation lies in `region`."""
    n_reg = _lookup(t("region", "r_regionkey"), t("nation", "n_regionkey"))
    nation_ok = (n_reg >= 0) & (t("region", "r_name")[n_reg] == region.encode())
    nrow = _lookup(t("nation", "n_nationkey"), t("supplier", "s_nationkey"))
    return (nrow >= 0) & nation_ok[nrow]


def q02(t, size: int = 15, type_suffix: str = "BRASS", region: str = "EUROPE"):
    """Per part of the size and type, its suppliers in the region that ask
    the least of them."""
    ptype = t("part", "p_type")
    part_ok = (t("part", "p_size") == size) & np.char.endswith(ptype, type_suffix.encode())
    prow = _lookup(t("part", "p_partkey"), t("partsupp", "ps_partkey"))
    srow = _lookup(t("supplier", "s_suppkey"), t("partsupp", "ps_suppkey"))
    in_region = (prow >= 0) & (srow >= 0) & _region_supplier(t, region)[srow]
    cost = t("partsupp", "ps_supplycost")
    # the least cost over each part's in-region suppliers
    rows = np.flatnonzero(in_region)
    parts, inv = np.unique(prow[rows], return_inverse=True)
    least = np.full(len(parts), np.iinfo(np.int64).max)
    np.minimum.at(least, inv.reshape(-1), cost[rows])
    keep = rows[part_ok[prow[rows]] & (cost[rows] == least[inv.reshape(-1)])]
    s, p = srow[keep], prow[keep]
    nation = _nation_name(t, t("supplier", "s_nationkey")[s])
    bal, name = t("supplier", "s_acctbal")[s], t("supplier", "s_name")[s]
    pkey = t("part", "p_partkey")[p]
    order = np.lexsort((pkey, name, nation, -bal))[:100]
    return [(_dec(bal[i], 2), name[i].decode(), nation[i].decode(), int(pkey[i]),
             t("part", "p_mfgr")[p[i]].decode(), t("supplier", "s_address")[s[i]].decode(),
             t("supplier", "s_phone")[s[i]].decode(),
             t("supplier", "s_comment")[s[i]].decode()) for i in order]


def q09(t, color: str = "green"):
    """Profit (revenue less the supplier's cost) of the lines whose part
    name holds the color, per supplier nation and order year."""
    lpart, lsupp = t("lineitem", "l_partkey"), t("lineitem", "l_suppkey")
    prow = _lookup(t("part", "p_partkey"), lpart)
    srow = _lookup(t("supplier", "s_suppkey"), lsupp)
    orow = _lookup(t("orders", "o_orderkey"), t("lineitem", "l_orderkey"))
    radix = int(max(lsupp.max(), t("partsupp", "ps_suppkey").max())) + 1
    ps_key = t("partsupp", "ps_partkey") * radix + t("partsupp", "ps_suppkey")
    order_ps = np.argsort(ps_key)
    pos = _lookup(ps_key[order_ps], lpart * radix + lsupp)
    psrow = np.where(pos >= 0, order_ps[np.maximum(pos, 0)], -1)
    named = np.char.find(t("part", "p_name"), color.encode()) >= 0
    ok = (prow >= 0) & (srow >= 0) & (orow >= 0) & (psrow >= 0) & named[prow]
    rows = np.flatnonzero(ok)
    amount = (_revenue(t, rows) - t("partsupp", "ps_supplycost")[psrow[rows]]
              * t("lineitem", "l_quantity")[rows])
    nation = _nation_name(t, t("supplier", "s_nationkey")[srow[rows]])
    year = _year(t("orders", "o_orderdate")[orow[rows]])
    groups = {}
    for n_, y, a in zip(nation, year, amount):
        key = (n_.decode(), int(y))
        groups[key] = groups.get(key, 0) + int(a)
    keys = sorted(groups, key=lambda k: (k[0], -k[1]))
    return [k + (_dec(groups[k], 4),) for k in keys]


def q13(t, words=("special", "requests")):
    """q13_nolike over the orders whose comment does not hold the words in
    order (o_comment NOT LIKE '%special%requests%')."""
    keep = ~_has_in_order(t("orders", "o_comment"), words)
    crow = _lookup(t("customer", "c_custkey"), t("orders", "o_custkey")[keep])
    per_cust = np.bincount(crow[crow >= 0], minlength=len(t("customer", "c_custkey")))
    counts, dist = np.unique(per_cust, return_counts=True)
    order = np.lexsort((-counts, -dist))
    return [(int(counts[i]), int(dist[i])) for i in order]


def q14(t, type_prefix: str = "PROMO"):
    """Share of the month's revenue from parts of the type prefix, as a
    DOUBLE: 100.00 × the promo sum (DECIMAL, scale 6) over the total
    (scale 4), each converted to a double as DECIMAL / DECIMAL binds."""
    ship = t("lineitem", "l_shipdate")
    prow = _lookup(t("part", "p_partkey"), t("lineitem", "l_partkey"))
    ok = (ship >= _day("1995-09-01")) & (ship < _day("1995-10-01")) & (prow >= 0)
    rows = np.flatnonzero(ok)
    if not len(rows):
        return [(None,)]
    revenue = _revenue(t, rows)
    promo = np.char.startswith(t("part", "p_type")[prow[rows]], type_prefix.encode())
    total = int(revenue.sum())
    return [((10_000 * int(revenue[promo].sum())) / 1e6 / (total / 1e4),)]


_Q16_SIZES = (49, 14, 23, 45, 19, 3, 36, 9)


def q16(t, remark=("Customer", "Complaints")):
    """Suppliers per (brand, type, size) of the parts that pass the filters,
    leaving out the suppliers whose comment holds the remark's words in
    order (s_comment LIKE '%Customer%Complaints%')."""
    brand, ptype, size = (t("part", c) for c in ("p_brand", "p_type", "p_size"))
    part_ok = ((brand != b"Brand#45") & ~np.char.startswith(ptype, b"MEDIUM POLISHED")
               & np.isin(size, _Q16_SIZES))
    bad = t("supplier", "s_suppkey")[_has_in_order(t("supplier", "s_comment"), remark)]
    prow = _lookup(t("part", "p_partkey"), t("partsupp", "ps_partkey"))
    supp = t("partsupp", "ps_suppkey")
    ok = (prow >= 0) & part_ok[prow] & ~np.isin(supp, bad)
    groups = {}
    for p, s in zip(prow[ok], supp[ok]):
        groups.setdefault((brand[p].decode(), ptype[p].decode(), int(size[p])), set()).add(int(s))
    keys = sorted(groups, key=lambda k: (-len(groups[k]),) + k)
    return [k + (len(groups[k]),) for k in keys]


def q20(t, color: str = "forest", nation: str = "CANADA"):
    """The nation's suppliers that hold more than half a year's shipped
    quantity (1994) of some part whose name starts with the color."""
    forest = t("part", "p_partkey")[np.char.startswith(t("part", "p_name"), color.encode())]
    ship = t("lineitem", "l_shipdate")
    year = (ship >= _day("1994-01-01")) & (ship < _day("1995-01-01"))
    radix = int(t("supplier", "s_suppkey").max()) + 1
    lkey = t("lineitem", "l_partkey")[year] * radix + t("lineitem", "l_suppkey")[year]
    keys, qsum = _group_sum(lkey, t("lineitem", "l_quantity")[year])
    ps_key = t("partsupp", "ps_partkey") * radix + t("partsupp", "ps_suppkey")
    pos = _lookup(keys, ps_key)
    # ps_availqty > 0.5 × sum(l_quantity): NULL (no line) is not greater;
    # sum is DECIMAL scale 2, so availqty · 1000 > 5 · qsum exactly
    avail = t("partsupp", "ps_availqty")
    ok = (np.isin(t("partsupp", "ps_partkey"), forest) & (pos >= 0)
          & (avail * 1000 > 5 * np.where(pos >= 0, qsum[np.maximum(pos, 0)], 0)))
    held = t("partsupp", "ps_suppkey")[ok]
    s_ok = (np.isin(t("supplier", "s_suppkey"), held)
            & _nation_rows(t, "supplier", "s", nation.encode()))
    names, addr = t("supplier", "s_name")[s_ok], t("supplier", "s_address")[s_ok]
    order = np.argsort(names, kind="stable")
    return [(names[i].decode(), addr[i].decode()) for i in order]


def q06(t):
    """Revenue of the year's discounted small lines: sum(price × discount),
    DECIMAL scale 4 (NULL over no line)."""
    ship, disc, qty = (t("lineitem", c) for c in ("l_shipdate", "l_discount", "l_quantity"))
    ok = ((ship >= _day("1994-01-01")) & (ship < _day("1995-01-01"))
          & (disc >= 5) & (disc <= 7) & (qty < 2400))
    if not ok.any():
        return [(None,)]
    return [(_dec(int((t("lineitem", "l_extendedprice")[ok] * disc[ok]).sum()), 4),)]


Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")


def q22(t, codes=Q22_CODES):
    """Customers without orders whose phone's country code is listed and
    whose balance is above the average positive balance of those codes:
    their count and balance per code. avg(DECIMAL) is double(sum) /
    (double(n) × 100), and the DECIMAL balance compares with it as a
    double."""
    cc = t("customer", "c_phone").astype("S2")  # the first two characters
    bal = t("customer", "c_acctbal")
    listed = np.isin(cc, [c.encode() for c in codes])
    pos = listed & (bal > 0)
    avg = float(bal[pos].sum()) / (float(pos.sum()) * 100.0)
    no_order = ~np.isin(t("customer", "c_custkey"), t("orders", "o_custkey"))
    ok = listed & (bal / 100.0 > avg) & no_order
    uniq, inv = np.unique(cc[ok], return_inverse=True)
    counts = np.bincount(inv.reshape(-1), minlength=len(uniq))
    sums = np.zeros(len(uniq), dtype=np.int64)
    np.add.at(sums, inv.reshape(-1), bal[ok])
    return [(u.decode(), int(n), _dec(s, 2)) for u, n, s in zip(uniq, counts, sums)]


def _exact_dot(a: np.ndarray, b: np.ndarray) -> int:
    """Σ a·b of int64 vectors as a Python int (the products fit int64; the
    sum is taken in chunks so that no partial sum overflows)."""
    prod = a * b
    return sum(int(prod[i:i + (1 << 16)].sum()) for i in range(0, len(prod), 1 << 16))


def general_agg(t):
    """GENERAL_QUERIES["general_agg"] per (returnflag, linestatus): the
    variance family and corr from exact integer moment sums, the median
    interpolated, quantile_disc, mode, first/arg_max, bool_or, product,
    count FILTER and string min/max. quantile_disc(x, 0.9) takes the value
    at floor or ceil of the reference's position start + (n − 1)·0.9 in
    float64 (ceil when its fraction is above 0.5), where start is the
    number of rows in the groups before (they sort by the same keys as
    the output)."""
    import math

    li = {c: t("lineitem", c) for c in (
        "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice", "l_discount",
        "l_orderkey", "l_partkey", "l_shipmode", "l_shipinstruct", "l_comment")}
    rf, ls = li["l_returnflag"], li["l_linestatus"]
    rows, start = [], 0
    for r, s in sorted(set(zip(rf.tolist(), ls.tolist()))):
        idx = np.flatnonzero((rf == r) & (ls == s))
        n = len(idx)
        q, p = li["l_quantity"][idx], li["l_extendedprice"][idx]
        sq, sp = int(q.sum()), int(p.sum())
        dq = n * _exact_dot(q, q) - sq * sq  # n²·var_pop, in cents²
        dp = n * _exact_dot(p, p) - sp * sp
        sd_qty = math.sqrt(dq / (n * (n - 1) * 10 ** 4)) if n > 1 else None
        var_price = dp / (n * n * 10 ** 4)
        qs = np.sort(q)
        half = (n - 1) * 0.5
        lo_f, hi_f = int(qs[math.floor(half)]) / 100.0, int(qs[math.ceil(half)]) / 100.0
        med = lo_f + (hi_f - lo_f) * (half - math.floor(half))
        ps = np.sort(p)
        fpos = float(start) + float(n - 1) * 0.9
        k = math.ceil(fpos) if fpos - math.floor(fpos) > 0.5 else math.floor(fpos)
        modes, mode_n = np.unique(li["l_shipmode"][idx], return_counts=True)
        sel = li["l_orderkey"][idx] < 1000
        growth = (float(np.prod((100 + li["l_discount"][idx][sel]) / 100.0))
                  if sel.any() else None)
        num = n * _exact_dot(q, p) - sq * sp
        corr = num / (math.sqrt(dq) * math.sqrt(dp))
        rows.append((
            r.decode(), s.decode(), sd_qty, var_price, med, _dec(ps[k - start], 2),
            modes[np.argmax(mode_n)].decode(), int(li["l_orderkey"][idx][np.argmax(p)]),
            int(li["l_partkey"][idx][np.argmax(q)]), bool((q > 4900).any()), growth,
            int((li["l_discount"][idx] > 5).sum()), min(li["l_shipinstruct"][idx]).decode(),
            max(li["l_comment"][idx]).decode(), corr))
        start += n
    return rows


def _groups(*keys):
    """(sorted unique key rows, each row's group id) over parallel columns."""
    if len(keys) == 1:
        uniq, inv = np.unique(keys[0], return_inverse=True)
        return [(u,) for u in uniq], inv.reshape(-1)
    rec = np.rec.fromarrays(keys)
    uniq, inv = np.unique(rec, return_inverse=True)
    return [tuple(u) for u in uniq], inv.reshape(-1)


def _sums(inv, n, values) -> np.ndarray:
    out = np.zeros(n, dtype=np.int64)
    np.add.at(out, inv, values.astype(np.int64))
    return out


def _reduce_at(inv, n, values, ufunc, ident) -> np.ndarray:
    out = np.full(n, ident, dtype=values.dtype)
    ufunc.at(out, inv, values)
    return out


_DAYNAMES = ("Thursday", "Friday", "Saturday", "Sunday", "Monday", "Tuesday", "Wednesday")


def fn_dates(t):
    """FUNCTION_QUERIES["fn_dates"]: per ship year (date_trunc gives a
    TIMESTAMP), the line count, quantity sum, days from ship to receipt,
    the latest month end of a ship date, the first day name (in string
    order) of a commit date and the lines received on a weekend."""
    ship, commit, receipt, qty = (t("lineitem", c) for c in (
        "l_shipdate", "l_commitdate", "l_receiptdate", "l_quantity"))
    year = ship.astype("datetime64[D]").astype("datetime64[Y]").astype(np.int64) + 1970
    keys, inv = _groups(year)
    n = len(keys)
    month_end = ((ship.astype("datetime64[D]").astype("datetime64[M]") + 1)
                 .astype("datetime64[D]").astype(np.int64) - 1)
    last = _reduce_at(inv, n, month_end, np.maximum, np.iinfo(np.int64).min)
    dow = (commit + 0) % 7  # 1970-01-01 was a Thursday
    seen = np.zeros((n, 7), dtype=bool)
    seen[inv, dow] = True
    weekend = ((receipt + 3) % 7 + 1) >= 6
    counts = np.bincount(inv, minlength=n)
    return [(datetime.datetime(int(y), 1, 1), int(counts[g]), _dec(_sums(inv, n, qty)[g], 2),
             int(_sums(inv, n, receipt - ship)[g]), _date(last[g]),
             min(_DAYNAMES[d] for d in np.flatnonzero(seen[g])),
             int(_sums(inv, n, weekend)[g]))
            for g, (y,) in enumerate(keys)]


_M64 = (1 << 64) - 1


def hash64_np(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer in numpy uint64 (the engine's hash())."""
    h = x.astype(np.int64).view(np.uint64)
    with np.errstate(over="ignore"):
        h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return h ^ (h >> np.uint64(31))


def hll_estimate(values: np.ndarray, inv: np.ndarray, n: int) -> np.ndarray:
    """HyperLogLog per group as DuckDB and the engine compute it: 2,048
    registers, register = the low 11 bits of the hash, rho = leading zeros
    of the other 53 bits plus one, the raw estimate with linear counting
    below 2.5 × 2,048 when a register is empty, rounded half to even."""
    m, p_bits = 2048, 11
    h = hash64_np(values)
    idx = (h & np.uint64(m - 1)).astype(np.int64)
    rest = h << np.uint64(p_bits)
    lz = np.full(len(h), 64, dtype=np.int64)
    nz = rest != 0
    # leading zeros of a nonzero uint64: 63 minus the top bit's position
    lz[nz] = 63 - np.floor(np.log2(rest[nz].astype(np.float64))).astype(np.int64)
    # the float log2 can round up at a power-of-two boundary; correct it
    top = np.uint64(1) << (63 - lz[nz]).astype(np.uint64)
    lz[nz] += (rest[nz] < top).astype(np.int64)
    rho = np.minimum(lz + 1, 64 - p_bits + 1)
    regs = np.zeros(n * m, dtype=np.int64)
    np.maximum.at(regs, inv * m + idx, rho)
    r = regs.reshape(n, m).astype(np.float64)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    est = alpha * m * m / np.power(2.0, -r).sum(axis=1)
    zeros = (r == 0.0).sum(axis=1)
    linear = m * np.log(m / np.maximum(zeros, 1).astype(np.float64))
    est = np.where((est <= 2.5 * m) & (zeros > 0), linear, est)
    return np.round(est).astype(np.int64)


def fn_math(t):
    """FUNCTION_QUERIES["fn_math"] per (returnflag, linestatus), with
    DuckDB's truncating % and // (the integer quantity's remainder by 7,
    -linenumber // 2 rounded toward zero), the bit aggregates by numpy's
    bitwise reductions, the engine's hash as numpy uint64 and HyperLogLog
    with the same hash and registers (`hll_estimate`)."""
    li = {c: t("lineitem", c) for c in (
        "l_returnflag", "l_linestatus", "l_quantity", "l_linenumber", "l_tax", "l_discount",
        "l_shipmode", "l_orderkey", "l_suppkey", "l_partkey", "l_extendedprice")}
    keys, inv = _groups(li["l_returnflag"], li["l_linestatus"])
    n = len(keys)
    qty_int = (li["l_quantity"] + 50) // 100  # CAST(DECIMAL AS INTEGER), non-negative
    ln = li["l_linenumber"]
    cols = [
        _sums(inv, n, np.fmod(qty_int, 7)),
        _sums(inv, n, -(ln // 2)),  # -ln // 2 truncated, ln > 0
        _sums(inv, n, np.maximum(li["l_tax"], li["l_discount"])),
        _sums(inv, n, ln != 1),
        _sums(inv, n, li["l_shipmode"] == b"AIR"),
        _sums(inv, n, np.gcd(li["l_orderkey"], ln)),
        _reduce_at(inv, n, li["l_orderkey"], np.bitwise_xor, 0),
        _reduce_at(inv, n, li["l_suppkey"], np.bitwise_or, 0),
        _reduce_at(inv, n, li["l_partkey"] + 1048576, np.bitwise_and, -1),
        _reduce_at(inv, n, hash64_np(li["l_orderkey"]).view(np.int64), np.bitwise_xor, 0),
        hll_estimate(li["l_partkey"], inv, n),
    ]
    counts = np.bincount(inv, minlength=n)
    log_price = np.zeros(n)
    np.add.at(log_price, inv, np.log(li["l_extendedprice"] / 100.0))
    log_qty = np.zeros(n)
    np.add.at(log_qty, inv, np.log(li["l_quantity"] / 100.0))
    rows = []
    for g, (rf, ls) in enumerate(keys):
        c = [int(col[g]) for col in cols]
        rows.append((rf.decode(), ls.decode(), c[0], c[1], _dec(c[2], 2), *c[3:],
                     float(log_price[g] / counts[g]), float(math.exp(log_qty[g] / counts[g]))))
    return rows


def fn_math_distinct(t):
    """The exact distinct l_partkey count per (returnflag, linestatus) of
    fn_math, which approx_count_distinct must lie near."""
    keys, inv = _groups(t("lineitem", "l_returnflag"), t("lineitem", "l_linestatus"))
    pairs = np.unique(inv * (1 << 32) + t("lineitem", "l_partkey"))
    return np.bincount(pairs >> 32, minlength=len(keys)).tolist()


def fn_strings(t):
    """FUNCTION_QUERIES["fn_strings"]: parts grouped by the first five
    characters of their name; the 20 largest groups (ties by key)."""
    names = t("part", "p_name").astype(object)
    names = np.array([s.decode() for s in names], dtype=object)
    brands = [s.decode() for s in t("part", "p_brand")]
    keys, inv = _groups(np.array([s[:5] for s in names], dtype=str))
    n = len(keys)
    count = np.bincount(inv, minlength=n)
    pos = _sums(inv, n, np.array([s.find("green") + 1 for s in names]))
    tail = _sums(inv, n, np.array([ord(s[-4:][0]) if s else 0 for s in names]))
    best = [""] * n
    low = [None] * n
    for g, s, b in zip(inv.tolist(), names, brands):
        r = s[::-1]
        r = r[:1].upper() + r[1:].lower()
        best[g] = max(best[g], r)
        padded = b[:12] if len(b) >= 12 else ("*" * 12)[:12 - len(b)] + b
        low[g] = padded if low[g] is None else min(low[g], padded)
    order = sorted(range(n), key=lambda g: (-count[g], keys[g][0]))[:20]
    return [(str(keys[g][0]), int(count[g]), int(pos[g]), best[g], low[g], int(tail[g]))
            for g in order]


def fn_casts(t):
    """FUNCTION_QUERIES["fn_casts"] per order month: the count, the price
    sum, the latest order date as TIMESTAMP text, the 1-based positions of
    'special' in the comments and the comments' first character codes."""
    day = t("orders", "o_orderdate")
    month = day.astype("datetime64[D]").astype("datetime64[M]")
    keys, inv = _groups(month.astype(np.int64))
    n = len(keys)
    comment = t("orders", "o_comment")
    pos = np.char.find(comment, b"special") + 1
    first = comment.view(np.uint8).reshape(len(comment), -1)[:, 0].astype(np.int64)
    last = _reduce_at(inv, n, day, np.maximum, np.iinfo(np.int64).min)
    count = np.bincount(inv, minlength=n)
    price = _sums(inv, n, t("orders", "o_totalprice"))
    spos, asc = _sums(inv, n, pos), _sums(inv, n, first)
    return [(str(np.datetime64(int(m), "M")), int(count[g]), _dec(price[g], 2),
             f"{_date(last[g]).isoformat()} 00:00:00", int(spos[g]), int(asc[g]))
            for g, (m,) in enumerate(keys)]


def _text(t, table: str, col: str) -> list:
    return [v.decode() for v in t(table, col)]


def _factorize(a: np.ndarray):
    """(sorted unique byte strings, each row's index among them) of an 'S'
    array, sorted as big-endian 64-bit words (np.unique sorts the strings
    themselves, which takes seconds over lineitem at SF1)."""
    w = a.dtype.itemsize
    mat = np.zeros((len(a), w + (-w) % 8), dtype=np.uint8)
    mat[:, :w] = a.view(np.uint8).reshape(len(a), w)
    words = mat.view(">u8").astype(np.uint64)
    order = np.lexsort(words.T[::-1])
    sw = words[order]
    change = np.ones(len(a), dtype=bool)
    change[1:] = (sw[1:] != sw[:-1]).any(axis=1)
    inv = np.empty(len(a), dtype=np.int64)
    inv[order] = np.cumsum(change) - 1
    return a[order[change]], inv


def _pair_runs(inv, codes, n_codes):
    """(group, code) pairs → (group, code, first row, count) per distinct
    pair, in (group, code) order."""
    pair = inv.astype(np.int64) * n_codes + codes
    uniq, first, count = np.unique(pair, return_index=True, return_counts=True)
    return uniq // n_codes, uniq % n_codes, first, count


def nested_agg(t):
    """NESTED_QUERIES["nested_agg"] per (l_returnflag, l_linestatus): the
    ship modes' counts in key order, AIR's count, the number of modes, the
    two most frequent modes (a tie goes to the mode seen first in row
    order), the distinct ship instructions in first-seen order, a bit per
    line number from the least to the greatest over all rows, the count
    and the quantity sum."""
    flags, fcode = _factorize(t("lineitem", "l_returnflag"))
    stats, scode = _factorize(t("lineitem", "l_linestatus"))
    gkeys, inv = np.unique(fcode * len(stats) + scode, return_inverse=True)
    inv = inv.reshape(-1)
    keys = [(flags[k // len(stats)], stats[k % len(stats)]) for k in gkeys.tolist()]
    n = len(keys)
    modes, mcode = _factorize(t("lineitem", "l_shipmode"))
    instrs, icode = _factorize(t("lineitem", "l_shipinstruct"))
    line = t("lineitem", "l_linenumber")
    qty = _sums(inv, n, t("lineitem", "l_quantity"))
    count = np.bincount(inv, minlength=n)
    lo, hi = int(line.min()), int(line.max())
    mg, mc, mfirst, mcount = _pair_runs(inv, mcode, len(modes))
    ig, ic, ifirst, _ = _pair_runs(inv, icode, len(instrs))
    bg, bpos, _, _ = _pair_runs(inv, line - lo, hi - lo + 1)
    out = []
    for g, key in enumerate(keys):
        sel = mg == g
        hist = {modes[c].decode(): int(k) for c, k in zip(mc[sel], mcount[sel])}
        order = np.lexsort((mfirst[sel], -mcount[sel]))[:2]
        top = [modes[c].decode() for c in mc[sel][order]]
        isel = ig == g
        seen = [instrs[c].decode() for c in ic[isel][np.argsort(ifirst[isel])]]
        bits = np.zeros(hi - lo + 1, dtype=np.uint8)
        bits[bpos[bg == g]] = 1
        out.append((key[0].decode(), key[1].decode(), hist, hist.get("AIR"), len(hist), top,
                    seen, "".join(map(str, bits.tolist())), int(count[g]), _dec(qty[g], 2)))
    return out


def nested_collect(t):
    """NESTED_QUERIES["nested_collect"]: orders grouped by their line
    count, with the sum of each order's least part key, of all its part
    keys and the count of its even part keys."""
    okey, part = t("lineitem", "l_orderkey"), t("lineitem", "l_partkey")
    orders, inv = np.unique(okey, return_inverse=True)
    inv = inv.reshape(-1)
    n = len(orders)
    length = np.bincount(inv, minlength=n)
    least = _reduce_at(inv, n, part, np.minimum, np.iinfo(np.int64).max)
    total = _sums(inv, n, part)
    evens = _sums(inv, n, (part % 2 == 0).astype(np.int64))
    out = []
    for k in np.unique(length).tolist():
        sel = length == k
        out.append((k, int(sel.sum()), int(least[sel].sum()), int(total[sel].sum()),
                    int(evens[sel].sum())))
    return out


def nested_words(t):
    """NESTED_QUERIES["nested_words"]: the ten most frequent words of the
    part names (ties by word)."""
    counts = {}
    for name in _text(t, "part", "p_name"):
        for w in name.split(" "):
            counts[w] = counts.get(w, 0) + 1
    return sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:10]


def nested_pack(t):
    """NESTED_QUERIES["nested_pack"] per p_size: the count, the part keys'
    sum, the names holding the word green, the least second word."""
    size, key = t("part", "p_size"), t("part", "p_partkey")
    names = _text(t, "part", "p_name")
    out = []
    for sz in np.unique(size).tolist():
        rows = np.flatnonzero(size == sz).tolist()
        words = [names[r].split(" ") for r in rows]
        out.append((sz, len(rows), int(key[rows].sum()), sum("green" in w for w in words),
                    min(w[1] if len(w) > 1 else None for w in words)))
    return out


def nested_pack_agg(t):
    """NESTED_QUERIES["nested_pack_agg"] per s_nationkey: the count and the
    supplier names joined by ',' in descending balance, ties by name."""
    nation, bal = t("supplier", "s_nationkey"), t("supplier", "s_acctbal")
    names = _text(t, "supplier", "s_name")
    out = []
    for nk in np.unique(nation).tolist():
        rows = np.flatnonzero(nation == nk).tolist()
        rows.sort(key=lambda r: (-int(bal[r]), names[r]))
        out.append((nk, len(rows), ",".join(names[r] for r in rows)))
    return out


def _iso_year_week(days: np.ndarray):
    """ISO-8601 (year, week) of day numbers: those of the week's Thursday."""
    thursday = days - (days + 3) % 7 + 3  # 1970-01-01 was a Thursday
    year = thursday.astype("datetime64[D]").astype("datetime64[Y]").astype(np.int64) + 1970
    jan1 = (year - 1970).astype("datetime64[Y]").astype("datetime64[D]").astype(np.int64)
    return year, (thursday - jan1) // 7 + 1


def more_dates(t):
    """MORE_QUERIES["more_dates"] per o_orderstatus: the count, the ISO
    years and year-weeks, the days since the epoch (through milliseconds),
    the days since 1992-01-01, January 1st of the latest year, the
    millennia and the Julian days."""
    day = t("orders", "o_orderdate")
    keys, inv = _groups(t("orders", "o_orderstatus"))
    n = len(keys)
    year = day.astype("datetime64[D]").astype("datetime64[Y]").astype(np.int64) + 1970
    iso_year, week = _iso_year_week(day)
    count = np.bincount(inv, minlength=n)
    top = _reduce_at(inv, n, year, np.maximum, np.iinfo(np.int64).min)
    sums = [_sums(inv, n, v) for v in (iso_year, iso_year * 100 + week, day,
                                       day - _day("1992-01-01"), (year - 1) // 1000 + 1,
                                       day + 2440588)]
    return [(k.decode(), int(count[g]), *(int(v[g]) for v in sums[:4]),
             datetime.datetime(int(top[g]), 1, 1), int(sums[4][g]), float(sums[5][g]))
            for g, (k,) in enumerate(keys)]


def more_math(t):
    """MORE_QUERIES["more_math"] per (l_returnflag, l_linestatus): sums of
    acosh, asinh and cot over the DECIMAL columns as doubles, the lines
    whose tax is below 0.04 and the count."""
    keys, inv = _groups(t("lineitem", "l_returnflag"), t("lineitem", "l_linestatus"))
    n = len(keys)
    qty, price, tax, disc = (t("lineitem", c) for c in (
        "l_quantity", "l_extendedprice", "l_tax", "l_discount"))

    def fsum(v):
        return np.bincount(inv, weights=v, minlength=n)

    acosh = fsum(np.arccosh(qty / 100.0 + 1.0))
    asinh = fsum(np.arcsinh(price / 100.0))
    cot = fsum(1.0 / np.tan(disc / 100.0 + 0.5))
    below = _sums(inv, n, tax < 4)
    count = np.bincount(inv, minlength=n)
    return [(f.decode(), s.decode(), float(acosh[g]), float(asinh[g]), int(below[g]),
             float(cot[g]), int(count[g])) for g, (f, s) in enumerate(keys)]


def _osa_distance(a: str, b: str) -> int:
    """Optimal string alignment distance (adjacent transpositions)."""
    prev2, prev = None, list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        cur = [i] + [0] * len(b)
        for j in range(1, len(b) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (a[i - 1] != b[j - 1]))
            if i > 1 and j > 1 and a[i - 1] == b[j - 2] and a[i - 2] == b[j - 1]:
                cur[j] = min(cur[j], prev2[j - 2] + 1)
        prev2, prev = prev, cur
    return prev[len(b)]


def more_text(t):
    """MORE_QUERIES["more_text"] per p_mfgr: name bits, base64 lengths, the
    greatest name SHA-256, the names' character-set Jaccard similarity to
    'almond', the containers' edit distance to 'JUMBO PKG' with
    transpositions, the distinct types, the greatest second lowercase word
    and the greatest type (a file name without a slash is itself)."""
    import hashlib
    import re

    names, containers = _text(t, "part", "p_name"), _text(t, "part", "p_container")
    types = _text(t, "part", "p_type")
    keys, inv = _groups(t("part", "p_mfgr"))
    n = len(keys)
    almond = set("almond")
    words = re.compile("[a-z]+")
    cache = {}
    out = [[0, 0, "", 0.0, 0, set(), None, ""] for _ in range(n)]
    for g, name, cont, typ in zip(inv.tolist(), names, containers, types):
        o = out[g]
        raw = name.encode()
        o[0] += 8 * len(raw)
        o[1] += 4 * ((len(raw) + 2) // 3)
        o[2] = max(o[2], hashlib.sha256(raw).hexdigest())
        o[3] += len(set(name) & almond) / len(set(name) | almond)
        if cont not in cache:
            cache[cont] = _osa_distance(cont, "JUMBO PKG")
        o[4] += cache[cont]
        o[5].add(typ)
        w = words.findall(name)
        if len(w) > 1 and (o[6] is None or w[1] > o[6]):
            o[6] = w[1]
        o[7] = max(o[7], typ)
    return [(k.decode(), o[0], o[1], o[2], o[3], o[4], len(o[5]), o[6], o[7])
            for (k,), o in zip(keys, out)]


def parity_lists(t):
    """MORE_QUERIES["parity_lists"] per p_size % 5 over v = [p_size,
    p_partkey % 7]: the dot products with [1, 2], the greatest distance to
    [10, 3], twice the count (each zip of v with itself has two entries),
    the greatest grade of v ([2, 1] where p_size > p_partkey % 7, else
    [1, 2]) and a third element that the resize fills with 0."""
    size, key = t("part", "p_size"), t("part", "p_partkey")
    m = key % 7
    keys, inv = _groups(size % 5)
    n = len(keys)
    dot = np.bincount(inv, weights=(size + 2 * m).astype(np.float64), minlength=n)
    dist = _reduce_at(inv, n, np.sqrt((size - 10.0) ** 2 + (m - 3.0) ** 2), np.maximum, -1.0)
    count = np.bincount(inv, minlength=n)
    down = _sums(inv, n, size > m)
    return [(int(k), float(dot[g]), float(dist[g]), 2 * int(count[g]),
             [2, 1] if down[g] else [1, 2], 0) for g, (k,) in enumerate(keys)]


def json_orders(t):
    """MORE_QUERIES["json_orders"] per o_orderpriority: the count and the
    sum of o_orderkey % 10, which the JSON documents carry."""
    keys, inv = _groups(t("orders", "o_orderpriority"))
    n = len(keys)
    count = np.bincount(inv, minlength=n)
    digits = _sums(inv, n, t("orders", "o_orderkey") % 10)
    return [(k.decode(), int(count[g]), int(digits[g])) for g, (k,) in enumerate(keys)]


def _nulls_last(rows):
    return sorted(rows, key=lambda r: tuple((v is None, "" if v is None else v) for v in r))


def rollup_q1(t):
    """Q1's measures per (l_returnflag, l_linestatus), per l_returnflag
    and over all rows, with grouping(l_returnflag)."""
    ship = t("lineitem", "l_shipdate")
    keep = ship <= _day("1998-09-02")
    qty, price = t("lineitem", "l_quantity")[keep], t("lineitem", "l_extendedprice")[keep]
    disc, tax = t("lineitem", "l_discount")[keep], t("lineitem", "l_tax")[keep]
    rf, ls = t("lineitem", "l_returnflag")[keep], t("lineitem", "l_linestatus")[keep]
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    rows = []
    for sets in ((rf, ls), (rf,), ()):
        if sets:
            keys, inv = _groups(*sets)
        else:
            keys, inv = [()], np.zeros(len(qty), dtype=np.int64)
        n = len(keys)
        cnt = np.bincount(inv, minlength=n)
        sq, sp, sd = _sums(inv, n, qty), _sums(inv, n, price), _sums(inv, n, disc_price)
        sc, sdisc = _sums(inv, n, charge), _sums(inv, n, disc)
        for g, k in enumerate(keys):
            key = [v.decode() for v in k] + [None] * (2 - len(k))
            rows.append((*key, 0 if sets else 1, _dec(sq[g], 2), _dec(sp[g], 2),
                         _dec(sd[g], 4), _dec(sc[g], 6), float(sq[g] / (cnt[g] * 100.0)),
                         float(sp[g] / (cnt[g] * 100.0)), float(sdisc[g] / (cnt[g] * 100.0)),
                         int(cnt[g])))
    return _nulls_last(rows)


def cube_flags(t):
    rf, ls = t("lineitem", "l_returnflag"), t("lineitem", "l_linestatus")
    qty = t("lineitem", "l_quantity")
    rows = []
    for mask in ((1, 1), (1, 0), (0, 1), (0, 0)):
        cols = [c for c, m in zip((rf, ls), mask) if m]
        keys, inv = _groups(*cols) if cols else ([()], np.zeros(len(qty), dtype=np.int64))
        n = len(keys)
        cnt, sq = np.bincount(inv, minlength=n), _sums(inv, n, qty)
        for g, k in enumerate(keys):
            vals = iter(v.decode() for v in k)
            key = [next(vals) if m else None for m in mask]
            rows.append((*key, int(cnt[g]), _dec(sq[g], 2)))
    return _nulls_last(rows)


def setops_big(t):
    qty, avail = t("lineitem", "l_quantity"), t("partsupp", "ps_availqty")
    # l_quantity is DECIMAL(15,2); ps_availqty an INTEGER widened to it
    return [(len(qty) + len(avail), _dec(int(qty.sum()) + 100 * int(avail.sum()), 2))]


def _setop_sides(t):
    import collections

    ship = t("lineitem", "l_shipdate")
    left = t("lineitem", "l_partkey")[(ship >= _day("1995-01-01")) & (ship < _day("1995-03-01"))]
    right = t("part", "p_partkey")[t("part", "p_size") < 20]
    return collections.Counter(left.tolist()), collections.Counter(right.tolist())


def _count_sum(keys):
    keys = list(keys)
    return [(len(keys), sum(keys) if keys else None)]


def setops_intersect(t):
    left, right = _setop_sides(t)
    return _count_sum(left.keys() & right.keys())


def setops_except(t):
    left, right = _setop_sides(t)
    return _count_sum(left.keys() - right.keys())


def setops_intersect_all(t):
    left, right = _setop_sides(t)
    return _count_sum((left & right).elements())


def setops_except_all(t):
    left, right = _setop_sides(t)
    return _count_sum((left - right).elements())


def values_join(t):
    labels = np.array(["west", "east", "north", "south"])[t("supplier", "s_nationkey") % 4]
    keys, inv = _groups(labels)
    n = len(keys)
    cnt, acct = np.bincount(inv, minlength=n), _sums(inv, n, t("supplier", "s_acctbal"))
    return [(str(k[0]), int(cnt[g]), _dec(acct[g], 2)) for g, k in enumerate(keys)]


def recursive_months(t):
    days = t("orders", "o_orderdate")
    dates = [_date(d) for d in np.unique(days)]
    ym_of = {np.int64((d - _EPOCH).days): d.year * 12 + d.month for d in dates}
    ym = np.array([ym_of[d] for d in days.tolist()]) if len(days) else np.zeros(0, np.int64)
    lo, hi = 1992 * 12 + 1, 1998 * 12 + 12
    vals, counts = np.unique(ym[(ym >= lo) & (ym <= hi)], return_counts=True)
    return [(int(v), int(c)) for v, c in zip(vals, counts)]


def mark_q4(t):
    late = t("lineitem", "l_commitdate") < t("lineitem", "l_receiptdate")
    has_late = np.isin(t("orders", "o_orderkey"), t("lineitem", "l_orderkey")[late])
    odate = t("orders", "o_orderdate")
    ok = (odate >= _day("1993-07-01")) & (odate < _day("1993-10-01"))
    keys, inv = _groups(t("orders", "o_orderpriority")[ok])
    sums = _sums(inv, len(keys), has_late[ok])
    return [(k[0].decode(), int(sums[g])) for g, k in enumerate(keys)]


def mark_in_or(t):
    building = t("customer", "c_custkey")[t("customer", "c_mktsegment") == b"BUILDING"]
    price = t("orders", "o_totalprice")
    ok = np.isin(t("orders", "o_custkey"), building) | (price > 40_000_000)
    keys, inv = _groups(t("orders", "o_orderstatus")[ok])
    n = len(keys)
    cnt, tot = np.bincount(inv, minlength=n), _sums(inv, n, price[ok])
    return [(k[0].decode(), int(cnt[g]), _dec(tot[g], 2)) for g, k in enumerate(keys)]


def notin_residual(t):
    """A lineitem row stays unless a partsupp row of its part with
    ps_availqty > l_quantity * 100 has its supplier (no key is NULL)."""
    ps_part, ps_supp = t("partsupp", "ps_partkey"), t("partsupp", "ps_suppkey")
    ps_key = ps_part * 1_000_000_000 + ps_supp
    order = np.argsort(ps_key)
    l_key = t("lineitem", "l_partkey") * 1_000_000_000 + t("lineitem", "l_suppkey")
    pos = np.clip(np.searchsorted(ps_key[order], l_key), 0, len(order) - 1)
    row = order[pos]
    found = ps_key[row] == l_key
    qty = t("lineitem", "l_quantity")  # cents: l_quantity * 100 is qty
    excluded = found & (t("partsupp", "ps_availqty")[row] * 100 > qty * 100)
    keep = ~excluded
    return [(int(keep.sum()), _dec(int(qty[keep].sum()), 2))]


def asof_ship(t):
    okey = t("orders", "o_orderkey")
    row = _lookup(okey, t("lineitem", "l_orderkey"))
    ok = (row >= 0) & (t("lineitem", "l_shipdate") >= t("orders", "o_orderdate")[row])
    return [(int(ok.sum()), _dec(int(t("orders", "o_totalprice")[row[ok]].sum()), 2))]


def band_join(t):
    acct = np.sort(t("supplier", "s_acctbal"))
    price = t("part", "p_retailprice")
    n = np.searchsorted(acct, price + 100, side="right") - np.searchsorted(acct, price - 100)
    return [(int(n.sum()),)]


def cross_small(t):
    names = sorted(v.decode() for v in t("region", "r_name"))
    nations = t("nation", "n_nationkey")
    return [(nm, len(nations), int(nations.sum())) for nm in names]


def positional(t):
    a = t("lineitem", "l_quantity")[t("lineitem", "l_linenumber") == 1]
    b = t("lineitem", "l_discount")[t("lineitem", "l_returnflag") == b"R"]
    m = min(len(a), len(b))
    return [(max(len(a), len(b)), _dec(int(a.sum()), 2), _dec(int(b.sum()), 2),
             _dec(int((a[:m] * b[:m]).sum()), 4))]


def _using_sides(t):
    okey = t("orders", "o_orderkey")
    o_cust = t("orders", "o_custkey")[okey % 7 == 0]
    c_cust = t("customer", "c_custkey")[t("customer", "c_nationkey") < 10]
    return o_cust, c_cust


def using_left(t):
    o_cust, c_cust = _using_sides(t)
    hit = np.isin(o_cust, c_cust)  # customer keys are unique
    return [(len(o_cust), int(hit.sum()), int(o_cust.sum()))]


def using_full(t):
    o_cust, c_cust = _using_sides(t)
    hit = np.isin(o_cust, c_cust)
    c_unmatched = c_cust[~np.isin(c_cust, o_cust)]
    n = len(o_cust) + len(c_unmatched)
    return [(n, n, int(o_cust.sum()) + int(c_unmatched.sum()), len(o_cust),
             int(hit.sum()) + len(c_unmatched))]


def natural_join(t):
    machinery = t("customer", "c_custkey")[t("customer", "c_mktsegment") == b"MACHINERY"]
    ok = np.isin(t("orders", "o_custkey"), machinery) & (t("orders", "o_orderstatus") == b"F")
    return [(int(ok.sum()), int(t("orders", "o_custkey")[ok].sum()),
             _dec(int(t("orders", "o_totalprice")[ok].sum()), 2))]


def sample_rows(t):
    return [(min(100_000, len(t("lineitem", "l_orderkey"))),)]


def _runs(keys: np.ndarray) -> np.ndarray:
    """Each row's run id over sorted keys (a run: equal neighbours)."""
    return np.cumsum(np.r_[True, keys[1:] != keys[:-1]]) - 1


def win_rank_lineitem(t):
    """rank() = 1 where a line's price is its order's largest."""
    okey, price = t("lineitem", "l_orderkey"), t("lineitem", "l_extendedprice")
    order = np.argsort(okey, kind="stable")
    run = _runs(okey[order])
    top = np.maximum.reduceat(price[order], np.flatnonzero(np.r_[True, np.diff(run) > 0]))
    keep = np.empty(len(okey), dtype=bool)
    keep[order] = price[order] == top[run]
    keys, inv = _groups(t("lineitem", "l_returnflag")[keep], t("lineitem", "l_linestatus")[keep])
    cnt, s = np.bincount(inv, minlength=len(keys)), _sums(inv, len(keys), price[keep])
    return [(k[0].decode(), k[1].decode(), int(cnt[g]), _dec(s[g], 2))
            for g, k in enumerate(keys)]


def win_running_orders(t):
    """Running sums of o_totalprice per priority in (date, key) order."""
    prio, price = t("orders", "o_orderpriority"), t("orders", "o_totalprice")
    order = np.lexsort((t("orders", "o_orderkey"), t("orders", "o_orderdate"), prio))
    p_s, x = prio[order], price[order]
    run = _runs(p_s)
    starts = np.flatnonzero(np.r_[True, np.diff(run) > 0])
    c = np.cumsum(x)
    rs = c - (c - x)[starts][run]
    return [(p_s[st].decode(), int(n), _dec(int(m), 2), _dec(int(sm), 2))
            for st, n, m, sm in zip(starts, np.diff(np.r_[starts, len(x)]),
                                    np.maximum.reduceat(rs, starts), np.add.reduceat(rs, starts))]


def win_frames_lineitem(t):
    """Per l_suppkey in (shipdate, orderkey, linenumber) order: a 7-row
    trailing avg of l_quantity, a 7-row centred min and max of
    l_extendedprice, and the l_quantity of the last 30 days (peers in)."""
    supp, ship = t("lineitem", "l_suppkey"), t("lineitem", "l_shipdate")
    order = np.lexsort((t("lineitem", "l_linenumber"), t("lineitem", "l_orderkey"), ship, supp))
    sp, sh = supp[order], ship[order]
    q, pr = t("lineitem", "l_quantity")[order], t("lineitem", "l_extendedprice")[order]
    rf = t("lineitem", "l_returnflag")[order]
    n = len(sp)
    idx = np.arange(n)
    run = _runs(sp)
    starts = np.flatnonzero(np.r_[True, np.diff(run) > 0])
    first = starts[run]
    last = np.r_[starts[1:] - 1, n - 1][run]
    cq = np.r_[0, np.cumsum(q)]
    lo = np.maximum(idx - 6, first)
    a7 = (cq[idx + 1] - cq[lo]) / ((idx - lo + 1) * 100.0)
    mn, mx = pr.copy(), pr.copy()
    for d in (1, 2, 3):
        for j in (idx - d, idx + d):
            ok = (j >= first) & (j <= last)
            v = pr[np.clip(j, 0, n - 1)]
            mn = np.where(ok, np.minimum(mn, v), mn)
            mx = np.where(ok, np.maximum(mx, v), mx)
    key = sp.astype(np.int64) * 100_000 + sh
    r30 = cq[np.searchsorted(key, key, side="right")] - cq[np.searchsorted(key, key - 30)]
    keys, inv = _groups(rf)
    k = len(keys)
    cnt = np.bincount(inv, minlength=k)
    s_a7 = np.bincount(inv, weights=a7, minlength=k)
    return [(keys[g][0].decode(), int(cnt[g]), float(s_a7[g]),
             _dec(_sums(inv, k, mn)[g], 2), _dec(_sums(inv, k, mx)[g], 2),
             _dec(_sums(inv, k, r30)[g], 2)) for g in range(k)]


def win_lag_lead(t):
    okey, ship = t("lineitem", "l_orderkey"), t("lineitem", "l_shipdate")
    order = np.lexsort((t("lineitem", "l_linenumber"), okey))
    o_s, sh = okey[order], ship[order]
    has_prev = np.r_[False, o_s[1:] == o_s[:-1]]
    earlier = has_prev & (sh < np.r_[0, sh[:-1]])
    return [(len(o_s), int(has_prev.sum()), int(has_prev.sum()), int(earlier.sum()))]


def win_dist_partsupp(t):
    """ntile(4), percent_rank, cume_dist and dense_rank per part in
    supply-cost order, summed per tile."""
    pk, cost = t("partsupp", "ps_partkey"), t("partsupp", "ps_supplycost")
    order = np.lexsort((cost, pk))
    p_s, c_s = pk[order], cost[order]
    n = len(p_s)
    idx = np.arange(n)
    run = _runs(p_s)
    starts = np.flatnonzero(np.r_[True, np.diff(run) > 0])
    first = starts[run]
    size = np.diff(np.r_[starts, n])[run]
    peer = np.cumsum(np.r_[True, (p_s[1:] != p_s[:-1]) | (c_s[1:] != c_s[:-1])]) - 1
    pstarts = np.flatnonzero(np.r_[True, np.diff(peer) > 0])
    peer_first = pstarts[peer]
    peer_last = np.r_[pstarts[1:] - 1, n - 1][peer]
    pr = np.where(size > 1, (peer_first - first) / np.maximum(size - 1, 1), 0.0)
    cd = (peer_last - first + 1) / size
    dr = peer - peer[first] + 1
    k = idx - first
    base, rem = size // 4, size % 4
    n4 = np.where(k < rem * (base + 1), k // (base + 1),
                  rem + (k - rem * (base + 1)) // np.maximum(base, 1)) + 1
    out = []
    for tile in np.unique(n4):
        m = n4 == tile
        out.append((int(tile), int(m.sum()), float(pr[m].sum()), float(cd[m].sum()),
                    int(dr[m].sum())))
    return out


def win_median_part(t):
    brand, price = t("part", "p_brand"), t("part", "p_retailprice")
    out = []
    for b in np.unique(brand):
        v = np.sort(price[brand == b]) / 100.0
        pos = (len(v) - 1) * 0.5
        lo, hi = int(math.floor(pos)), int(math.ceil(pos))
        out.append((b.decode(), len(v), float(v[lo] * (1.0 - (pos - lo)) + v[hi] * (pos - lo))))
    return out


def qualify_top3(t):
    nk, ck, bal = (t("customer", c) for c in ("c_nationkey", "c_custkey", "c_acctbal"))
    order = np.lexsort((ck, -bal, nk))
    run = _runs(nk[order])
    starts = np.flatnonzero(np.r_[True, np.diff(run) > 0])
    rn = np.arange(len(order)) - starts[run] + 1
    return [(int(nk[i]), int(ck[i]), _dec(bal[i], 2), int(r))
            for i, r in zip(order, rn) if r <= 3]


def distinct_on_nation(t):
    """The first customer of each nation by c_acctbal DESC; of equal
    balances, the first in row order (the port's stable sort; DuckDB may
    give any of them)."""
    nk, bal = t("customer", "c_nationkey"), t("customer", "c_acctbal")
    order = np.lexsort((np.arange(len(nk)), -bal, nk))
    firsts = order[np.r_[True, nk[order][1:] != nk[order][:-1]]]
    return [(int(nk[i]), int(t("customer", "c_custkey")[i]),
             t("customer", "c_name")[i].decode(), _dec(bal[i], 2)) for i in firsts]


_ANSWERS = {"q02": q02, "q03": q03, "q04": q04, "q05": q05, "q07": q07, "q08": q08,
            "q09": q09, "q10": q10, "q11": q11, "q12": q12, "q13": q13,
            "q13_nolike": q13_nolike, "q14": q14, "q15": q15, "q16": q16, "q17": q17,
            "q18": q18, "q19": q19, "q20": q20, "q21": q21, "q06": q06, "q22": q22,
            "general_agg": general_agg, "fn_dates": fn_dates, "fn_math": fn_math,
            "fn_strings": fn_strings, "fn_casts": fn_casts, "nested_agg": nested_agg,
            "nested_collect": nested_collect, "nested_words": nested_words,
            "nested_pack": nested_pack, "nested_pack_agg": nested_pack_agg,
            "more_dates": more_dates, "more_math": more_math, "more_text": more_text,
            "parity_lists": parity_lists, "json_orders": json_orders,
            "rollup_q1": rollup_q1, "cube_flags": cube_flags, "setops_big": setops_big,
            "setops_intersect": setops_intersect, "setops_except": setops_except,
            "setops_intersect_all": setops_intersect_all,
            "setops_except_all": setops_except_all, "values_join": values_join,
            "recursive_months": recursive_months, "mark_q4": mark_q4, "mark_in_or": mark_in_or,
            "notin_residual": notin_residual, "asof_ship": asof_ship, "band_join": band_join,
            "cross_small": cross_small, "positional": positional, "using_left": using_left,
            "using_full": using_full, "natural_join": natural_join, "sample_rows": sample_rows,
            **{name: globals()[name] for name in WINDOW_QUERIES}}


def answer(name: str, data_dir: str, **params):
    """Rows of query `name` (a key of QUERIES, SUBQUERY_QUERIES,
    FROM_QUERIES, LIKE_QUERIES, GENERAL_QUERIES, FUNCTION_QUERIES,
    NESTED_QUERIES, MORE_QUERIES, SELECT_FORM_QUERIES or WINDOW_QUERIES) over data_dir;
    params go to the query's
    answer (Q2's `size`/`type_suffix`/`region`, Q7's `nation1`/`nation2`,
    Q8's `nation`/`region`/`ptype`, Q9's `color`, Q11's `nation`, Q13's
    `words`, Q14's `type_prefix`, Q16's `remark`, Q18's `threshold`, Q20's
    `color`/`nation`, Q22's `codes`)."""
    return _ANSWERS[name](_Tables(data_dir), **params)
