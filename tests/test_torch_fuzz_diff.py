"""The fuzzer's queries through both packages: the port (device="cpu")
against the JAX package, row for row.

Seeds 1, 7, 11 and 99 × 150 run over SETUP in duckdb_tpu and in
duckdb_tpu_torch. Where both answer, the rows must agree as phase 23 of
chip_smoke.py compares them (duckdb_tpu_torch/testing/fuzz.rows_differ:
DOUBLE within 1e-9 relative, else exact; in order under a top-level ORDER
BY without LIMIT, the first column in order with one, the row count only
under a LIMIT without ORDER BY, else as multisets). A query the JAX
package answers and the port refuses fails too, unless it is one of the
forms listed below, where the port follows DuckDB and the JAX package
does not (ROADMAP Queue 3): F14, a function called with an argument too
many (the JAX package ignores it), and F16, a LIST compared with a
non-LIST (the JAX package answers NULL or false). Each listed query is
named by seed and index and held to DuckDB's outcome: a BindError.
F13 (HUGEINT sums past 64 bits), F18 (the variance of equal values) and
cot(x, NULL) do not occur in these seeds' answered queries; their forms
are held to exact answers in test_torch_hugeint_aggs.py and
test_torch_fuzz.py.
"""

import pytest
import torch

import duckdb_tpu
import duckdb_tpu_torch
from duckdb_tpu.testing.fuzz import SETUP as J_SETUP
from duckdb_tpu.testing.fuzz import SqlFuzzer as JFuzzer
from duckdb_tpu_torch.planner.bound import BindError
from duckdb_tpu_torch.testing import fuzz as TF

torch.set_num_threads(1)

N = 150

# (seed, index) → (form, the text of DuckDB's Binder Error)
LISTED = {
    (1, 0): ("F14", "No function matches the given name and argument types 'sqrt("),
    (1, 67): ("F14", "No function matches the given name and argument types 'length("),
    (1, 84): ("F16", "Cannot compare values of type DECIMAL(4,3)[] and type BIGINT"),
    (7, 73): ("F14", "No function matches the given name and argument types 'sqrt("),
    (7, 103): ("F14", "No function matches the given name and argument types 'bit_count("),
    (7, 124): ("F14", "No function matches the given name and argument types 'abs("),
}


@pytest.fixture(scope="module")
def cons():
    jcon = duckdb_tpu.connect()
    for stmt in J_SETUP:
        jcon.sql(stmt)
    return jcon, TF.setup_connection(duckdb_tpu_torch.connect(device="cpu"))


@pytest.mark.parametrize("seed", [1, 7, 11, 99])
def test_port_agrees_with_the_jax_package(cons, seed):
    jcon, tcon = cons
    ours, theirs = TF.SqlFuzzer(seed), JFuzzer(seed)
    answered, problems, listed = 0, [], set()
    for i in range(N):
        sql = ours.query()
        assert sql == theirs.query()
        kj, vj = TF.run_one(jcon, sql)
        kt, vt = TF.run_one(tcon, sql)
        if kt == "error" and not TF.is_typed(vt):
            problems.append((i, sql, f"port raised {type(vt).__name__}: {vt}"))
        if (seed, i) in LISTED:
            listed.add(i)
            form, text = LISTED[(seed, i)]
            assert kj == "rows", (form, sql, vj)
            assert kt == "error" and isinstance(vt, BindError) and text in str(vt), \
                (form, sql, vt)
            continue
        if kj == kt == "rows":
            answered += 1
            why = TF.rows_differ(sql, vt, vj)
            if why:
                problems.append((i, sql, f"{why}: port {vt[:5]} jax {vj[:5]}"))
        elif kj == "rows":
            problems.append((i, sql, f"the JAX package answers, the port refuses: {vt}"))
    assert not problems, "\n".join(f"{seed}/{i}: {what}\n  {sql}" for i, sql, what in problems)
    assert listed == {i for s, i in LISTED if s == seed}
    assert answered >= N * 0.2
