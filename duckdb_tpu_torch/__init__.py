"""duckdb_tpu_torch: the PyTorch/CUDA port of duckdb_tpu.

The same SQL engine as the JAX package beside it (duckdb_tpu), written in
PyTorch for an NVIDIA H100, with hand-written CUDA kernels where the JAX
package has Pallas kernels. `connect()` puts every column and
intermediate on the CUDA device unless the caller passes device="cpu".
This package imports neither jax nor duckdb_tpu.

The module-level API (DuckDB's Python package: `duckdb.sql(...)` without a
connect()) runs over one connection made at first use on the default
device, `default_connection()`. As in the JAX package and DuckDB's own
package, the `sql` function shadows the `duckdb_tpu_torch.sql` subpackage
as an attribute; `from duckdb_tpu_torch.sql.parser import Parser` still
imports it.
"""

from duckdb_tpu_torch.api.connection import Connection, connect  # noqa: F401

_default_con = None


def default_connection() -> Connection:
    """The module-level API's connection, made on first use."""
    global _default_con
    if _default_con is None:
        _default_con = connect()
    return _default_con


def sql(query: str):  # noqa: F811 — shadows the subpackage, as DuckDB's does
    return default_connection().sql(query)


def query(q: str):
    return default_connection().sql(q)


def execute(q: str):
    return default_connection().sql(q)


def table(name: str):
    return default_connection().table(name)


def read_csv(path: str):
    return default_connection().read_csv(path)


def read_parquet(path: str):
    return default_connection().read_parquet(path)


def from_df(df, name=None):
    """Needs pandas: waits for ROADMAP item 35b, as Connection.from_df does."""
    from duckdb_tpu_torch.planner.bound import not_ported

    raise not_ported("from_df (pandas; ROADMAP item 35b)")


__version__ = "0.1.0"
