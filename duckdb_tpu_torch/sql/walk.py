"""Small helpers over the parse tree (sql/nodes.py) that several
statements share: finding the column references of an expression, and
making the FROM item of a catalog key."""

from __future__ import annotations

from duckdb_tpu_torch.sql import nodes as N


def column_refs(e):
    """Every ColumnRef node of an expression tree."""
    if isinstance(e, N.ColumnRef):
        yield e
    elif isinstance(e, (list, tuple)):
        for x in e:
            yield from column_refs(x)
    elif hasattr(e, "__dataclass_fields__"):
        for f in e.__dataclass_fields__:
            yield from column_refs(getattr(e, f))


def table_ref(key: str, alias=None) -> N.BaseTableRef:
    """The FROM item of a catalog key ("t" or "schema.t")."""
    schema, _, name = key.rpartition(".")
    return N.BaseTableRef(name, schema=schema or None, alias=alias)
