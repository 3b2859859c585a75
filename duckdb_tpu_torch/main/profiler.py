"""The profile of EXPLAIN ANALYZE: per-operator times and row counts.

As in the JAX package (duckdb_tpu/main/profiler.py) and DuckDB's
QueryProfiler (src/main/query_profiler.cpp): `profile_executor` wraps an
Executor so that every plan node it executes is timed into a tree of
OperatorProfile, each with its live row count. torch runs device work
asynchronously, so an operator's time is its host time up to the read of
its row count, which waits for the device (Batch.count_live): the time
includes the operator's device work. A node's time includes its
children's, as the tree nests. Only the nodes that go through
Executor.execute appear: the fused aggregate path reads its scan, filter
and probe steps itself (execution/fused_agg.py), so they show as the
aggregate's time.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class OperatorProfile:
    name: str
    detail: str = ""
    time_s: float = 0.0
    cardinality: int = -1
    children: List["OperatorProfile"] = field(default_factory=list)

    def render(self, indent: int = 0) -> str:
        pad = "  " * indent
        card = f", {self.cardinality} rows" if self.cardinality >= 0 else ""
        lines = [f"{pad}{self.name}{self.detail} ({self.time_s * 1000:.2f} ms{card})"]
        lines += [c.render(indent + 1) for c in self.children]
        return "\n".join(lines)

    def walk(self):
        """This operator and every one below it, depth first."""
        yield self
        for c in self.children:
            yield from c.walk()

    def to_json(self):
        return {"name": self.name, "detail": self.detail,
                "time_ms": round(self.time_s * 1000, 3), "cardinality": self.cardinality,
                "children": [c.to_json() for c in self.children]}


@dataclass
class QueryProfile:
    query: str = ""
    phases: Dict[str, float] = field(default_factory=dict)
    root: Optional[OperatorProfile] = None
    total_s: float = 0.0
    result: object = None  # the query's Result (EXPLAIN ANALYZE returns the profile)

    def render(self) -> str:
        out = ["┌─────────────────────────────────────┐",
               "│         Query Profiling Result      │",
               "└─────────────────────────────────────┘",
               self.query.strip(), "",
               f"Total Time: {self.total_s * 1000:.2f} ms"]
        out += [f"  {ph}: {t * 1000:.2f} ms" for ph, t in self.phases.items()]
        if self.root is not None:
            out += ["", self.root.render()]
        return "\n".join(out)

    def to_json(self) -> str:
        return json.dumps({
            "query": self.query, "total_ms": round(self.total_s * 1000, 3),
            "phases": {k: round(v * 1000, 3) for k, v in self.phases.items()},
            "plan": self.root.to_json() if self.root else None,
        }, indent=2)


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        return dt


def profile_executor(executor, profile: QueryProfile):
    """Wrap `executor.execute` so each plan node it runs is timed into the
    profile's tree (a node executed again from the executor's memo of one
    run shows once)."""
    inner_execute = executor.execute
    stack: List[OperatorProfile] = []
    seen = set()

    def traced_execute(node):
        if id(node) in seen:
            return inner_execute(node)
        seen.add(id(node))
        op = OperatorProfile(type(node).__name__)
        if stack:
            stack[-1].children.append(op)
        else:
            profile.root = op
        stack.append(op)
        t0 = time.perf_counter()
        try:
            batch = inner_execute(node)
            op.cardinality = batch.count_live()  # waits for the device
        finally:
            op.time_s = time.perf_counter() - t0
            stack.pop()
        return batch

    executor.execute = traced_execute
    return executor
