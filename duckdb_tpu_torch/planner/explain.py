"""EXPLAIN rendering: a plan tree as indented text, one node a line, as
the JAX package renders it (DuckDB's src/common/render_tree.cpp draws
boxes; this is an indent tree). A set operation's inputs are indented
under it."""

from __future__ import annotations

from duckdb_tpu_torch.planner import plan as P


def render_plan(node, indent: int = 0) -> str:
    pad = "  " * indent
    name = type(node).__name__
    extra = ""
    if isinstance(node, P.Scan):
        extra = f" {node.table} [{len(node.cols)} cols]"
    elif isinstance(node, P.Join):
        extra = f" ({node.jtype}, {len(node.probe_keys)} keys)"
    elif isinstance(node, P.Aggregate):
        extra = f" ({len(node.groups)} groups, {len(node.aggs)} aggs)"
    elif isinstance(node, P.Project):
        extra = f" ({len(node.items)} exprs)"
    elif isinstance(node, P.Limit):
        extra = f" (n={node.n} offset={node.offset})"
    elif isinstance(node, P.Order):
        extra = f" ({len(node.items)} keys)"
    lines = [f"{pad}{name}{extra}"]
    for attr in ("child", "probe", "build", "left", "right"):
        c = getattr(node, attr, None)
        if c is not None:
            lines.append(render_plan(c, indent + 1))
    for c in getattr(node, "inputs", ()):
        lines.append(render_plan(c, indent + 1))
    return "\n".join(lines)
