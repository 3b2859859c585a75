"""Interactive SQL shell over the port: `python -m duckdb_tpu_torch.cli
[database] [-device cpu|cuda] [-csv|-json|-list|-box] [-c SQL]...`.

The JAX package's shell (duckdb_tpu/cli/__main__.py), after DuckDB's
(tools/shell/shell.cpp): line editing (readline), statements over several
lines ended by ';', the dot commands of HELP, the output modes of
cli/render.py, the timer, `-c` commands run in turn (then the shell
exits) and `.open`. The database opens on CUDA; `-device cpu` (the only
flag the JAX shell lacks) opens it on the CPU, and `.open` keeps the
device.
"""

from __future__ import annotations

import sys
import time

import duckdb_tpu_torch
from duckdb_tpu_torch.cli.render import RENDERERS

HELP = """\
.help              show this help
.tables            list tables
.schema [table]    show CREATE statements / column types
.mode MODE         output mode: box csv json list
.timer on|off      toggle per-query timing
.read FILE         execute SQL from a file
.open FILE         open a database directory
.databases         list attached databases
.maxrows N         rows shown in box mode
.exit / .quit      leave the shell
"""


class Shell:
    def __init__(self, database: str = ":memory:", device=None):
        self.device = device
        self.con = duckdb_tpu_torch.connect(database, device=device)
        self.mode = "box"
        self.timer = False
        self.max_rows = 40
        self.database = database

    # -- dot commands --------------------------------------------------------
    def dot(self, line: str) -> bool:
        """Run one dot command; False when it ends the shell."""
        parts = line.split()
        cmd = parts[0][1:].lower()
        args = parts[1:]
        if cmd in ("exit", "quit", "q"):
            return False
        if cmd == "help":
            print(HELP)
        elif cmd == "tables":
            for t in sorted(n for n in self.con.catalog.tables if not n.startswith("__")):
                print(t)
            for v in sorted(self.con.catalog.views):
                print(f"{v} (view)")
        elif cmd == "schema":
            names = args or sorted(n for n in self.con.catalog.tables if not n.startswith("__"))
            for t in names:
                if not self.con.catalog.has_table(t):
                    print(f"-- no such table: {t}")
                    continue
                e = self.con.catalog.get_table(t)
                cols = ",\n".join(f"  {c.name} {c.ltype}" for c in e.columns)
                print(f"CREATE TABLE {t} (\n{cols}\n);")
        elif cmd == "mode":
            if args and args[0] in RENDERERS:
                self.mode = args[0]
            else:
                print(f"modes: {', '.join(sorted(set(RENDERERS)))}")
        elif cmd == "timer":
            self.timer = bool(args) and args[0].lower() == "on"
        elif cmd == "maxrows":
            self.max_rows = int(args[0]) if args else 40
        elif cmd == "read":
            with open(args[0]) as f:
                self.run_sql(f.read())
        elif cmd == "open":
            self.con.close()
            self.con = duckdb_tpu_torch.connect(args[0], device=self.device)
            self.database = args[0]
        elif cmd == "databases":
            print(self.database)
        else:
            print(f'unknown command "{line}". Try .help')
        return True

    # -- SQL -----------------------------------------------------------------
    def run_sql(self, sql: str):
        t0 = time.perf_counter()
        try:
            res = self.con.sql(sql)
            shown = res is not None and res.names and not getattr(res, "_dml_count", False)
            rows = res.rows() if shown else None
        except Exception as e:  # noqa: BLE001 — the shell shows the error and goes on
            print(f"Error: {e}")
            return
        dt = time.perf_counter() - t0
        if rows is not None:
            renderer = RENDERERS[self.mode]
            if self.mode in ("box", "duckbox"):
                print(renderer(res.names, rows, self.max_rows))
            else:
                print(renderer(res.names, rows))
        if self.timer:
            print(f"Run Time: {dt:.3f}s")

    def repl(self):
        try:
            import readline  # noqa: F401  (line editing side effect)
        except ImportError:
            pass
        print(f"duckdb_tpu_torch {duckdb_tpu_torch.__version__} on {self.con.device}")
        print('Enter ".help" for usage hints.')
        buf = []
        while True:
            prompt = "D " if not buf else "· "
            try:
                line = input(prompt)
            except EOFError:
                print()
                break
            except KeyboardInterrupt:
                buf = []
                print()
                continue
            if not buf and line.strip().startswith("."):
                if not self.dot(line.strip()):
                    break
                continue
            buf.append(line)
            if line.rstrip().endswith(";"):
                sql = "\n".join(buf)
                buf = []
                self.run_sql(sql)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    db, device = ":memory:", None
    run_cmds = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-c":
            i += 1
            run_cmds.append(argv[i])
        elif a == "-device":
            i += 1
            device = argv[i]
        elif a in ("-csv", "-json", "-list", "-box"):
            run_cmds.insert(0, ".mode " + a[1:])
        elif not a.startswith("-"):
            db = a
        i += 1
    sh = Shell(db, device)
    try:
        if run_cmds:
            for c in run_cmds:
                if c.strip().startswith("."):
                    if not sh.dot(c.strip()):
                        break
                else:
                    sh.run_sql(c)
        else:
            sh.repl()
    finally:
        sh.con.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
