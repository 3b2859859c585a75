"""Result renderers of the port's shell: box / csv / json / list modes.

A copy of the JAX package's (duckdb_tpu/cli/render.py), after DuckDB's
shell output modes (tools/shell/shell_renderer.cpp).
"""

from __future__ import annotations

import json
from typing import List


def _fmt(v) -> str:
    if v is None:
        return "NULL"
    return str(v)


def render_box(names: List[str], rows: List[tuple], max_rows: int = 40) -> str:
    shown = rows[:max_rows]
    cells = [[_fmt(v) for v in r] for r in shown]
    widths = [len(n) for n in names]
    for r in cells:
        for i, c in enumerate(r):
            widths[i] = max(widths[i], len(c))
    sep = "┌" + "┬".join("─" * (w + 2) for w in widths) + "┐"
    mid = "├" + "┼".join("─" * (w + 2) for w in widths) + "┤"
    bot = "└" + "┴".join("─" * (w + 2) for w in widths) + "┘"
    out = [sep]
    out.append("│" + "│".join(f" {n:<{w}} " for n, w in zip(names, widths)) + "│")
    out.append(mid)
    for r in cells:
        out.append("│" + "│".join(f" {c:<{w}} " for c, w in zip(r, widths)) + "│")
    out.append(bot)
    if len(rows) > max_rows:
        out.append(f"({len(rows)} rows, {max_rows} shown)")
    else:
        out.append(f"({len(rows)} row{'s' if len(rows) != 1 else ''})")
    return "\n".join(out)


def render_csv(names, rows) -> str:
    def esc(s):
        s = _fmt(s)
        if "," in s or '"' in s or "\n" in s:
            return '"' + s.replace('"', '""') + '"'
        return s

    out = [",".join(esc(n) for n in names)]
    for r in rows:
        out.append(",".join(esc(v) for v in r))
    return "\n".join(out)


def render_json(names, rows) -> str:
    def conv(v):
        if v is None or isinstance(v, (int, float, str, bool)):
            return v
        return str(v)

    return json.dumps([dict(zip(names, (conv(v) for v in r))) for r in rows],
                      indent=2)


def render_list(names, rows) -> str:
    out = ["|".join(names)]
    for r in rows:
        out.append("|".join(_fmt(v) for v in r))
    return "\n".join(out)


RENDERERS = {"box": render_box, "csv": render_csv, "json": render_json,
             "list": render_list, "duckbox": render_box}
