"""The port stands alone: no jax, no duckdb_tpu, no pyarrow, and the card
unless asked.

The machine with the GPU has no JAX and no pyarrow, so duckdb_tpu_torch and
chip_smoke.py must import neither jax, nor anything of the JAX package, nor
pyarrow (the port reads and writes Parquet with its own codec). The port's
C++ sources (csrc/, capi/) name no module of the JAX package either: the C
API imports the port's own bridge.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import duckdb_tpu_torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the port's package, chip_smoke.py, and the tools that drive the port
PORT_TOOLS = ["torch_fuzz.py"] + sorted(p.name for p in (ROOT / "tools").glob("chip_phase*.py"))
PORT_FILES = sorted((ROOT / "duckdb_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
    [ROOT / "tools" / name for name in PORT_TOOLS]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|duckdb_tpu|pyarrow)\b", re.MULTILINE)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert not FORBIDDEN.findall(path.read_text()), path


# the port's C++ and CUDA sources (the kernels, the file readers' host
# libraries, the C API): a string naming a module of the JAX package
# ("duckdb_tpu.…", say the C API importing its bridge) or an include of
# its headers
CXX_FILES = sorted(p for d in ("csrc", "capi") for p in (ROOT / "duckdb_tpu_torch" / d).iterdir()
                   if p.suffix in (".cpp", ".cu", ".h", ".cuh"))
CXX_FORBIDDEN = re.compile(r'"duckdb_tpu\.|#\s*include\s*[<"](jax|duckdb_tpu/|duckdb_tpu\.h)')


@pytest.mark.parametrize("path", CXX_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_cxx_sources_name_no_jax_module(path):
    assert not CXX_FORBIDDEN.findall(path.read_text()), path


def test_scan_covers_the_new_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"duckdb_tpu_torch/testing/fuzz.py", "duckdb_tpu_torch/ops/int128.py",
            "duckdb_tpu_torch/parallel/shard.py", "tools/torch_fuzz.py",
            "tools/chip_phase23.py", "tools/chip_phase24.py",
            "duckdb_tpu_torch/api/arrow_interop.py", "tools/chip_phase25.py"} <= names


def test_cxx_scan_finds_what_it_forbids():
    assert {p.name for p in CXX_FILES} >= {"grouped_sum.cu", "csv2col.cpp", "capi.cpp",
                                           "duckdb_tpu_torch.h", "arrow_c.cpp"}
    for bad in ('PyImport_ImportModule("duckdb_tpu.capi.bridge")', '#include "duckdb_tpu.h"',
                "#include <duckdb_tpu/capi/capi.h>"):
        assert CXX_FORBIDDEN.search(bad), bad
    for good in ('PyImport_ImportModule("duckdb_tpu_torch.capi.bridge")',
                 '#include "duckdb_tpu_torch.h"', "/* a copy of duckdb_tpu/capi/capi.cpp */"):
        assert not CXX_FORBIDDEN.search(good), good


def test_imports_with_jax_blocked():
    """Every module of the port imports in a process where jax and
    duckdb_tpu cannot be imported at all."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "duckdb_tpu_torch").rglob("*.py"))
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['duckdb_tpu'] = None\n"
            "sys.modules['pyarrow'] = None\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "import chip_smoke\n"
            "assert not any(k in ('jax', 'pyarrow')\n"
            "               or k.startswith(('jax.', 'duckdb_tpu.', 'pyarrow.'))\n"
            "               for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_connect_defaults_to_cuda():
    if torch.cuda.is_available():
        assert duckdb_tpu_torch.connect().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            duckdb_tpu_torch.connect()
    assert duckdb_tpu_torch.connect(device="cpu").device.type == "cpu"


def test_not_yet_ported_sql_says_so():
    con = duckdb_tpu_torch.connect(device="cpu")
    con.sql("CREATE TABLE t (a INT)")
    with pytest.raises(ValueError, match="not yet ported"):
        con.sql("SELECT MAP {1: 2} AS m").arrow()  # a MAP has no Arrow export yet
    with pytest.raises(ValueError, match="not yet ported"):
        con.sql("SELECT hex(a) FROM t")  # refused by the JAX package too
