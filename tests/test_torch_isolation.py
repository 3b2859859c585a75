"""The port stands alone: no jax, no duckdb_tpu, no pyarrow, and the card
unless asked.

The machine with the GPU has no JAX and no pyarrow, so duckdb_tpu_torch and
chip_smoke.py must import neither jax, nor anything of the JAX package, nor
pyarrow (the port reads and writes Parquet with its own codec).
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
PORT_FILES = sorted((ROOT / "duckdb_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|duckdb_tpu|pyarrow)\b", re.MULTILINE)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert not FORBIDDEN.findall(path.read_text()), path


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
        con.sql("SELECT * FROM t").df()  # pandas: ROADMAP item 35b
    with pytest.raises(ValueError, match="not yet ported"):
        con.sql("SET threads = 2")  # a setting of ROADMAP item 36
