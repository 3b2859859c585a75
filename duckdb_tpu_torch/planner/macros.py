"""SQL macros: the default scalar macros and their expansion.

DuckDB binds a macro by substituting the caller's argument parse trees for
the parameter references in the stored body and binding the result
(duckdb/src/function/scalar_macro_function.cpp). As in the JAX package
(duckdb_tpu/planner/macros.py), `expand_call` deep-substitutes argument
expressions for single-part ColumnRefs naming a parameter; the connection
expands every macro call of a statement before planning (`expand_macros`),
so that aggregate detection sees the aggregates inside a body such as
geomean's, and the binder expands any call it meets (`expansion_guard`
stops a macro that calls itself).

The macros are the reference's default table
(duckdb/src/catalog/default/default_functions.cpp) as the JAX package
carries it, with the nested shims (list_*, array_*, map_contains_value),
json_group_array (to_json is storage/json_io.py's) and current_catalog.
CREATE MACRO keeps a user's macros in the catalog (`Catalog.macros`,
`Catalog.table_macros`); `active_macros` adds the statement's to these.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses

from duckdb_tpu_torch.sql import nodes as N


class MacroError(Exception):
    pass


@dataclasses.dataclass
class MacroDef:
    name: str
    params: tuple          # positional parameter names (lowered)
    defaults: dict         # name -> Expr AST (used when not supplied)
    body: object           # Expr AST (scalar) or SelectStatement (table)
    is_table: bool
    sql_text: str = ""     # the CREATE MACRO text a file database keeps


_MAX_DEPTH = 64
_depth = 0


def _rebuild(node, fn):
    """Apply fn to every field of a dataclass / list / tuple / dict node,
    keeping the node itself when nothing changed."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        kw = {}
        changed = False
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            nv = fn(v)
            kw[f.name] = nv
            changed = changed or nv is not v
        if not changed:
            return node
        out = dataclasses.replace(node, **kw)
        if hasattr(node, "_sql_text"):
            out._sql_text = node._sql_text
        return out
    if isinstance(node, list):
        return [fn(v) for v in node]
    if isinstance(node, tuple):
        return tuple(fn(v) for v in node)
    if isinstance(node, dict):
        return {k: fn(v) for k, v in node.items()}
    return node


def substitute(node, mapping):
    """Deep-copy `node` with single-part ColumnRefs replaced per `mapping`."""
    if isinstance(node, N.ColumnRef):
        rep = mapping.get(node.parts[0].lower())
        if rep is None:
            return node
        out = copy.deepcopy(rep)
        # param.field → struct_extract, as the reference binds dotted access
        for fieldname in node.parts[1:]:
            out = N.FunctionCall("struct_extract", [out, N.Literal(fieldname)])
        return out
    return _rebuild(node, lambda v: substitute(v, mapping))


def split_args(args):
    """Separate positional from `name := expr` named arguments."""
    pos, named = [], {}
    for a in args:
        if (isinstance(a, N.BinaryOp) and a.op == ":="
                and isinstance(a.left, N.ColumnRef) and len(a.left.parts) == 1):
            named[a.left.parts[0].lower()] = a.right
        else:
            pos.append(a)
    return pos, named


def expand_call(mac: MacroDef, args, named=None):
    """The macro body with the arguments substituted for the parameters."""
    named = dict(named or {})
    required = [p for p in mac.params if p not in mac.defaults]
    if len(args) > len(mac.params):
        raise MacroError(
            f"Macro function {mac.name!r} requires {len(required)} positional "
            f"arguments, but {len(args)} were provided")
    mapping = dict(zip(mac.params, args))
    for p in mac.params[len(args):]:
        if p in named:
            mapping[p] = named.pop(p)
        elif p in mac.defaults:
            mapping[p] = mac.defaults[p]
        else:
            raise MacroError(f"Macro function {mac.name!r}: missing argument {p!r}")
    if named:
        raise MacroError(f"Binder Error: Macro function {mac.name!r}: unknown named "
                         f"argument {next(iter(named))!r}")
    return substitute(mac.body, mapping)


def expand_macros(node, macros: dict, depth: int = 0):
    """Replace every scalar-macro FunctionCall of an AST (a whole statement
    too) with its expanded body, bottom-up."""
    if depth > _MAX_DEPTH:
        raise MacroError("Max expression depth limit of 1000 exceeded (recursive macro?)")
    if isinstance(node, N.FunctionCall):
        mac = macros.get(node.name.lower())
        if mac is not None and not mac.is_table:
            pos, named = split_args([expand_macros(a, macros, depth) for a in node.args])
            return expand_macros(expand_call(mac, pos, named), macros, depth + 1)
    return _rebuild(node, lambda v: expand_macros(v, macros, depth))


_DEFAULT_MACRO_SQL = [
    "CREATE MACRO current_role() AS 'duckdb'",
    "CREATE MACRO current_user() AS 'duckdb'",
    "CREATE MACRO user() AS current_user()",
    "CREATE MACRO session_user() AS 'duckdb'",
    "CREATE MACRO round_even(x, n) AS CASE ((abs(x) * power(10, n+1)) % 10)"
    " WHEN 5 THEN round(x/2, n) * 2 ELSE round(x, n) END",
    "CREATE MACRO roundbankers(x, n) AS round_even(x, n)",
    "CREATE MACRO fdiv(x, y) AS floor(x/y)",
    "CREATE MACRO fmod(x, y) AS (x-y*floor(x/y))",
    "CREATE MACRO geomean(x) AS exp(avg(ln(x)))",
    "CREATE MACRO geometric_mean(x) AS geomean(x)",
    "CREATE MACRO weighted_avg(value, weight) AS SUM(value * weight) / "
    "SUM(CASE WHEN value IS NOT NULL THEN weight ELSE 0 END)",
    "CREATE MACRO wavg(value, weight) AS weighted_avg(value, weight)",
    "CREATE MACRO date_add(date, i) AS date + i",
    "CREATE MACRO days_in_month(date) AS day(last_day(date))",
    "CREATE MACRO ago(i) AS current_timestamp - i",
    # the nested shims (list_append and list_prepend are native functions)
    "CREATE MACRO list_append(l, e) AS list_concat(l, list_value(e))",
    "CREATE MACRO array_append(arr, el) AS list_append(arr, el)",
    "CREATE MACRO list_prepend(e, l) AS list_concat(list_value(e), l)",
    "CREATE MACRO array_prepend(el, arr) AS list_prepend(el, arr)",
    "CREATE MACRO array_push_back(arr, e) AS list_concat(arr, list_value(e))",
    "CREATE MACRO array_push_front(arr, e) AS list_concat(list_value(e), arr)",
    "CREATE MACRO array_to_string(arr, sep) AS list_aggr(arr, 'string_agg', sep)",
    "CREATE MACRO array_to_string_comma_default(arr, sep := ',') AS "
    "list_aggr(arr, 'string_agg', sep)",
    "CREATE MACRO array_reverse(l) AS list_reverse(l)",
    "CREATE MACRO map_contains_value(map, value) AS contains(map_values(map), value)",
    "CREATE MACRO current_catalog() AS current_database()",
    # the json aggregate shim (DuckDB's is a native aggregate, json_create.cpp)
    "CREATE MACRO json_group_array(x) AS to_json(list(x))",
] + [
    f"CREATE MACRO list_{a}(l) AS list_aggr(l, '{a}')"
    for a in ("avg", "var_samp", "var_pop", "stddev_pop", "stddev_samp", "sem",
              "approx_count_distinct", "bit_xor", "bit_or", "bit_and", "bool_and", "bool_or",
              "count", "entropy", "last", "first", "any_value", "kurtosis", "kurtosis_pop",
              "min", "max", "product", "skewness", "sum", "string_agg", "mode", "median",
              "mad")
]

_DEFAULT_MACROS = None


def default_macros() -> dict:
    """name → MacroDef for the default macro table (parsed once). A name
    with a native function or aggregate is left out: the native one wins."""
    global _DEFAULT_MACROS
    if _DEFAULT_MACROS is None:
        from duckdb_tpu_torch.planner.binder import AGGREGATE_NAMES
        from duckdb_tpu_torch.planner.functions import REGISTRY
        from duckdb_tpu_torch.sql.parser import Parser

        out = {}
        for sql in _DEFAULT_MACRO_SQL:
            st = Parser(sql).parse_statements()[0]
            name = st.name.lower()
            if name in REGISTRY or name in AGGREGATE_NAMES:
                continue
            out[name] = MacroDef(name, tuple(p.lower() for p in st.params),
                                 dict(st.defaults), st.body, st.is_table)
        _DEFAULT_MACROS = out
    return _DEFAULT_MACROS


def active_macros() -> dict:
    """The default macros and the CREATE MACRO ones of the statement's
    catalog (the session's)."""
    from duckdb_tpu_torch.planner import session

    user = getattr(getattr(session.current(), "catalog", None), "macros", None)
    return {**default_macros(), **user} if user else default_macros()


@contextlib.contextmanager
def expansion_guard(name: str):
    """Guard the binding of an expanded macro body, so that a macro that
    calls itself fails with a clear error instead of exhausting the stack."""
    global _depth
    if _depth >= _MAX_DEPTH:
        raise MacroError("Max expression depth limit of 1000 exceeded binding macro "
                         f"{name!r} (recursive macro?)")
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1
