"""Settings registry and SET / RESET.

As in the JAX package (duckdb_tpu/main/settings.py) one table of settings
drives SET, RESET, current_setting() and duckdb_settings(); DuckDB
generates its settings surface the same way from one file
(src/common/settings.json). The table holds the JAX package's 24 own
settings, then DuckDB's other 163 (main/settings_compat.py), in the JAX
package's order, with its names, types, scopes and aliases.

What the port honours:
- `memory_limit` sets the device buffer pool's limit
  (catalog.set_memory_limit; above it columns leave the card and queries
  run in chunks); `temp_directory` is where out-of-core execution spills
  (storage/spill.py; empty: the system temp directory);
- `num_shards`, `auto_shard_rows` and `exchange_join_threshold`, which the
  sharded routes read (parallel/shard.py);
- `join_order`, 'dp' or 'greedy': the planner's join-order search;
- `default_order` and `default_null_order`: what an ORDER BY term that
  names no direction or NULLS placement takes, as in DuckDB;
- `enable_profiling` (PRAGMA enable_profiling / disable_profiling; as in
  the JAX package, only EXPLAIN ANALYZE profiles);
- `pallas_grouped_sum`, 'auto', 'on' or 'off': 'off' sends the int64 sums
  of up to 256 slots to index_add_ instead of the grouped-sum kernel
  (ops/grouped.py), as the JAX package's 'off' leaves its Pallas kernel;
  'auto' and 'on' launch the kernel on the card;
- `timezone`: 'UTC' only, since the calendar functions refuse other zones;
- the file database's `checkpoint_threshold` (alias wal_autocheckpoint),
  `debug_checkpoint_abort` and `debug_force_commit_failure`
  (api/connection.py, storage/persist.py).
The rest is accepted and stored, as in the JAX package, and says so in its
description.

Two defaults differ from the JAX package's. num_shards is 1 (one device),
not 0 (AUTO, every visible card once an operator's rows pass
auto_shard_rows): on four H100s AUTO made the joins, ORDER BY and the
window over TPC-H SF1 1.4-5.2x slower than one card (PERF.md, "Sharded at
SF1"); `SET num_shards = 0` asks for it. memory_limit is '0', no limit,
not "80% of HBM": the JAX package reads its budget from the TPU runtime,
and on the card a limit of the port's own making would send queries that
fit in 80 GB to chunks; `SET memory_limit = '48MB'` sets one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from duckdb_tpu_torch.main.settings_compat import COMPAT_SETTINGS, SETTING_ALIASES


@dataclass
class Setting:
    name: str
    default: object
    typ: str  # BIGINT / BOOLEAN / VARCHAR / DOUBLE / UBIGINT / ENUM<…> / VARCHAR[]
    scope: str  # GLOBAL / LOCAL
    description: str


_STORED = " (accepted and stored; no effect in the port)"

SETTINGS = [
    Setting("threads", 0, "BIGINT", "GLOBAL",
            "Host threads for native loaders (0 = hardware concurrency)" + _STORED),
    Setting("memory_limit", "0", "VARCHAR", "GLOBAL",
            "Device memory budget for resident columns (0 = none); above it "
            "columns leave the device and queries run in chunks"),
    Setting("enable_progress_bar", False, "BOOLEAN", "LOCAL",
            "Show progress for long queries" + _STORED),
    Setting("enable_profiling", False, "BOOLEAN", "LOCAL",
            "Set by PRAGMA enable_profiling / disable_profiling; EXPLAIN "
            "ANALYZE profiles each operator (main/profiler.py)"),
    Setting("explain_output", "physical_only", "VARCHAR", "LOCAL",
            "EXPLAIN rendering mode" + _STORED),
    Setting("default_null_order", "nulls_last", "VARCHAR", "LOCAL",
            "NULLS placement of an ORDER BY term that names none: nulls_last, "
            "nulls_first, nulls_first_on_asc_last_on_desc or "
            "nulls_last_on_asc_first_on_desc"),
    Setting("default_order", "asc", "VARCHAR", "LOCAL",
            "Direction of an ORDER BY term that names none: asc or desc"),
    Setting("temp_directory", "", "VARCHAR", "GLOBAL",
            "Directory for out-of-core spill files (empty = system temp)"),
    Setting("num_shards", 1, "BIGINT", "GLOBAL",
            "Shards for distributed execution (1 = one device, the default; "
            "0 = auto: every visible card when an operator's rows exceed "
            "auto_shard_rows; n > 1 = n shards, sharing cards round-robin "
            "when there are fewer)"),
    Setting("auto_shard_rows", 1 << 15, "BIGINT", "GLOBAL",
            "Row count above which auto sharding (num_shards = 0) "
            "distributes operators over the visible cards"),
    Setting("disabled_optimizers", "", "VARCHAR", "LOCAL",
            "Comma-separated optimizer passes to skip" + _STORED),
    Setting("join_order", "dp", "VARCHAR", "LOCAL",
            "Join order search: 'dp' (cardinality-costed dynamic program "
            "from three relations on) or 'greedy' (the probe spine)"),
    Setting("max_expression_depth", 1000, "BIGINT", "LOCAL",
            "Parser recursion guard" + _STORED),
    Setting("timezone", "UTC", "VARCHAR", "LOCAL",
            "Session time zone: UTC only (the calendar functions refuse "
            "other zones)"),
    Setting("preserve_insertion_order", True, "BOOLEAN", "GLOBAL",
            "Stable result ordering for unordered queries" + _STORED),
    Setting("checkpoint_threshold", "16MB", "VARCHAR", "GLOBAL",
            "WAL size that triggers automatic checkpoint"),
    Setting("enable_object_cache", True, "BOOLEAN", "GLOBAL",
            "Cache compiled query programs" + _STORED),
    Setting("exchange_join_threshold", 1 << 24, "BIGINT", "GLOBAL",
            "Dense-table size above which multi-shard joins repartition "
            "both sides by key hash instead of copying the build to every "
            "shard (0 = always exchange when sharded)"),
    Setting("pallas_grouped_sum", "auto", "VARCHAR", "GLOBAL",
            "Exact int64 grouped sums of up to 256 slots through the "
            "grouped-sum kernel: 'auto' and 'on' launch it on the card, "
            "'off' sums them with index_add_"),
    Setting("experimental_join_fusion", False, "BOOLEAN", "GLOBAL",
            "Fuse dense unique inner joins into aggregate programs" + _STORED),
    # fault-injection hooks (DuckDB's debug_* settings; crash-consistency
    # testing)
    Setting("debug_checkpoint_abort", "none", "VARCHAR", "GLOBAL",
            "Abort CHECKPOINT at a stage: none | before_data | "
            "before_header | before_truncate (crash-recovery testing)"),
    Setting("debug_force_commit_failure", False, "BOOLEAN", "GLOBAL",
            "Force every COMMIT to fail after validation "
            "(rollback-path testing)"),
    Setting("storage_compatibility_version", "latest", "VARCHAR", "GLOBAL",
            "Accepted for reference compatibility (single format)"),
    Setting("enable_macro_dependencies", False, "BOOLEAN", "GLOBAL",
            "Accepted for reference compatibility (macros expand at bind "
            "time; no dependency tracking needed)"),
]
SETTINGS += [Setting(n, d, t, sc, desc + " (accepted for reference compatibility; no "
                     "engine effect)") for n, d, t, sc, desc in COMPAT_SETTINGS]
BY_NAME: Dict[str, Setting] = {s.name: s for s in SETTINGS}

# the values the port checks, as the JAX package checks pallas_grouped_sum
_CHOICES = {
    "pallas_grouped_sum": ("auto", "on", "off"),
    "join_order": ("dp", "greedy"),
    "default_order": ("asc", "desc"),
    "default_null_order": ("nulls_last", "nulls_first", "nulls_first_on_asc_last_on_desc",
                           "nulls_last_on_asc_first_on_desc"),
}
# DuckDB's other spellings of those values
_SPELLINGS = {"ascending": "asc", "descending": "desc", "nulls first": "nulls_first",
              "nulls last": "nulls_last"}


def parse_bytes(v) -> int:
    """'512MB' / '2GiB' / '1e6' / int → bytes (0 = no limit)."""
    if isinstance(v, (int, float)):
        return int(v)
    s_ = str(v).strip().upper().replace("IB", "B")
    mult = 1
    for suffix, m in (("TB", 1 << 40), ("GB", 1 << 30), ("MB", 1 << 20),
                      ("KB", 1 << 10), ("B", 1)):
        if s_.endswith(suffix):
            s_ = s_[: -len(suffix)]
            mult = m
            break
    try:
        return int(float(s_) * mult)
    except ValueError:
        raise ValueError(f'Failed to parse memory limit "{v}": expected a '
                         'size like \'1GB\' (0 = unlimited)') from None


def canonical(name: str) -> str:
    """A setting's name (an alias resolved); raises for an unknown name."""
    name = name.lower()
    name = name if name in BY_NAME else SETTING_ALIASES.get(name, name)
    if name not in BY_NAME:
        raise ValueError(f'unrecognized configuration parameter "{name}"')
    return name


class SettingsManager:
    """The setting values of one database, shared by its connections. The
    memory limit is process-wide, as the device buffer pool is
    (catalog.POOL)."""

    def __init__(self):
        self.values: Dict[str, object] = {s.name: s.default for s in SETTINGS}

    def set(self, name: str, value):
        name = canonical(name)
        typ = BY_NAME[name].typ
        if typ == "BOOLEAN" and not isinstance(value, bool):
            value = str(value).lower() in ("true", "on", "1")
        elif name in _CHOICES:
            value = str(value).lower()
            value = _SPELLINGS.get(value, value)
            if value not in _CHOICES[name]:
                raise ValueError(f"{name} must be one of "
                                 f"{', '.join(repr(c) for c in _CHOICES[name])}, got '{value}'")
        elif name == "timezone":
            if str(value).upper() not in ("UTC", "GMT", "ETC/UTC"):
                raise ValueError(f'Not implemented Error: the time zone "{value}": the '
                                 "port's calendar functions are UTC only")
            value = "UTC"
        elif name == "checkpoint_threshold":
            parse_bytes(value)  # a size, or it raises
        elif name == "debug_checkpoint_abort":
            from duckdb_tpu_torch.storage.persist import ABORT_POINTS

            value = str(value).lower()
            if value not in ("none",) + ABORT_POINTS:
                raise ValueError(f"debug_checkpoint_abort takes none, {', '.join(ABORT_POINTS)}"
                                 f', got "{value}"')
        elif typ == "BIGINT":
            try:
                value = int(value)
            except (TypeError, ValueError):
                raise ValueError(f'{name} takes an integer, got "{value}"') from None
            if value < 0:
                raise ValueError(f"{name} cannot be negative")
        self._apply(name, value)

    def reset(self, name: str):
        name = canonical(name)
        self._apply(name, BY_NAME[name].default)

    def _apply(self, name: str, value):
        if name == "memory_limit":
            from duckdb_tpu_torch.catalog.catalog import set_memory_limit

            set_memory_limit(parse_bytes(value))
        self.values[name] = value

    def get(self, name: str, default=None):
        name = name.lower()
        return self.values.get(SETTING_ALIASES.get(name, name), default)

    def text(self, name: str) -> str:
        """The value as duckdb_settings() and current_setting() show it."""
        return str(self.values[canonical(name)])

    def rows(self):
        """duckdb_settings(): (name, value, description, input_type, scope)."""
        return [(s.name, str(self.values[s.name]), s.description, s.typ, s.scope)
                for s in SETTINGS]
