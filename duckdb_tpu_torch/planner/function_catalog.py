"""Every function name the port binds: what duckdb_functions() lists.

The JAX package's duckdb_tpu/planner/function_catalog.py over the port's
own tables: the scalar registry (planner/functions.REGISTRY, filled by
functions, functions_ext, functions_nested, functions_more,
functions_parity and storage/json_io), the aggregates and lambdas the
binder dispatches, the operators it rewrites from a function call, the
names it binds structurally, and the default macros. Window function
names (planner._bind_window_call) are recognized only in OVER (); the
aggregates that double as window functions are counted as aggregates.
"""

from __future__ import annotations

from duckdb_tpu_torch.planner import binder as _binder
from duckdb_tpu_torch.planner import functions_parity as _parity
from duckdb_tpu_torch.planner import macros as _macros
from duckdb_tpu_torch.planner.functions import REGISTRY

# recognized only in OVER ()
WINDOW_NAMES = frozenset({
    "row_number", "rank", "dense_rank", "rank_dense", "ntile", "lag", "lead", "first_value",
    "last_value", "nth_value", "percent_rank", "cume_dist", "fill"})

LAMBDA_NAMES = frozenset(_binder._LAMBDA_NAMES + _binder._REDUCE_NAMES)

OPERATOR_NAMES = frozenset(_binder.OPERATOR_NAMES)

# bound by the binder itself (named arguments, bind-time month intervals)
STRUCTURAL_NAMES = frozenset({"struct_insert", "struct_update"} | set(_parity.MONTH_INTERVAL_FNS))


def function_types() -> dict:
    """name → 'scalar', 'aggregate' or 'macro', as duckdb_functions() lists
    them (a name both a macro and a scalar is a macro: the binder expands
    it first)."""
    out = {n: "scalar" for n in REGISTRY}
    out.update({n: "scalar" for n in LAMBDA_NAMES | OPERATOR_NAMES | STRUCTURAL_NAMES})
    out.update({n: "aggregate" for n in _binder.AGGREGATE_NAMES})
    out.update({n: "macro" for n, m in _macros.default_macros().items() if not m.is_table})
    return out


def all_function_names() -> set:
    """Every SQL-callable function name the port recognizes."""
    return set(function_types()) | set(WINDOW_NAMES)
