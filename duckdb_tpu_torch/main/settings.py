"""Settings registry and SET / RESET.

As in the JAX package (duckdb_tpu/main/settings.py) one table of settings
drives SET and RESET; DuckDB generates its settings surface the same way
from one file (src/common/settings.json). The port honours the settings
whose effect it has: `num_shards`, `auto_shard_rows` and
`exchange_join_threshold`, which the sharded routes read
(parallel/shard.py), `memory_limit`, which sets the device buffer pool's
limit (catalog.set_memory_limit), and the file database's
`checkpoint_threshold` (the WAL size past which a commit checkpoints; its
alias is wal_autocheckpoint), `debug_checkpoint_abort` and
`debug_force_commit_failure` (api/connection.py, storage/persist.py).
Every other setting of the JAX
package's registry, its own and DuckDB's, is refused as not yet ported,
naming ROADMAP item 36: a SET that changed nothing would look as if it
had. current_setting() and duckdb_settings() wait for the same item, which
brings those settings' defaults, types and descriptions.

One default differs from the JAX package's: num_shards is 1 (one device),
not 0 (AUTO, every visible card once an operator's rows pass
auto_shard_rows). On four H100s AUTO made the joins, ORDER BY and the
window over TPC-H SF1 1.4-5.2x slower than one card (PERF.md, "Sharded at
SF1"); `SET num_shards = 0` asks for it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass
class Setting:
    name: str
    default: object
    typ: str  # BIGINT / BOOLEAN / VARCHAR
    description: str


SETTINGS = [
    Setting("memory_limit", "0", "VARCHAR",
            "Device memory budget for resident columns (0 = none); above it "
            "columns leave the device and queries run in chunks"),
    Setting("num_shards", 1, "BIGINT",
            "Shards for distributed execution (1 = one device, the default; "
            "0 = auto: every visible card when an operator's rows exceed "
            "auto_shard_rows; n > 1 = n shards, sharing cards round-robin "
            "when there are fewer)"),
    Setting("auto_shard_rows", 1 << 15, "BIGINT",
            "Row count above which auto sharding (num_shards = 0) "
            "distributes operators over the visible cards"),
    Setting("exchange_join_threshold", 1 << 24, "BIGINT",
            "Dense-table size above which multi-shard joins repartition "
            "both sides by key hash instead of copying the build to every "
            "shard (0 = always exchange when sharded)"),
    Setting("checkpoint_threshold", "16MB", "VARCHAR",
            "WAL size that triggers automatic checkpoint"),
    # fault-injection hooks (DuckDB's debug_* settings; crash-consistency
    # testing)
    Setting("debug_checkpoint_abort", "none", "VARCHAR",
            "Abort CHECKPOINT at a stage: none | before_data | "
            "before_header | before_truncate (crash-recovery testing)"),
    Setting("debug_force_commit_failure", False, "BOOLEAN",
            "Force every COMMIT to fail after validation "
            "(rollback-path testing)"),
]
BY_NAME: Dict[str, Setting] = {s.name: s for s in SETTINGS}

# the rest of the JAX package's registry (its own settings, then DuckDB's):
# SET and RESET of these raise "not yet ported"
NOT_PORTED = frozenset("""
threads enable_progress_bar enable_profiling explain_output
default_null_order default_order temp_directory disabled_optimizers
join_order max_expression_depth timezone preserve_insertion_order
enable_object_cache pallas_grouped_sum experimental_join_fusion
storage_compatibility_version enable_macro_dependencies
__delta_only_variant_encoding_enabled access_mode
allocator_background_threads allocator_bulk_deallocation_flush_threshold
allocator_flush_threshold allow_community_extensions
allow_extensions_metadata_mismatch allow_parser_override_extension
allow_persistent_secrets allow_unredacted_secrets allow_unsigned_extensions
allowed_configs allowed_directories allowed_paths
approximate_join_order_threshold arrow_large_buffer_size
arrow_lossless_conversion arrow_output_list_view arrow_output_version
asof_loop_join_threshold async_threads auto_checkpoint_skip_wal_threshold
autoinstall_extension_repository autoinstall_known_extensions
autoload_known_extensions block_allocator_memory cache_local_files
catalog_error_max_schemas checkpoint_on_detach configure_profiling
current_transaction_invalidation_policy custom_extension_repository
custom_user_agent debug_asof_iejoin debug_checkpoint_sleep_ms
debug_disable_optimizer debug_eviction_queue_sleep_micro_seconds
debug_force_commit_revert_failure debug_force_external debug_force_fetch_row
debug_force_no_cross_product debug_order_verification
debug_physical_table_scan_execution_strategy debug_skip_checkpoint_on_commit
debug_transformer_trampoline_style debug_verification_mode
debug_verification_projection debug_verify_aggregate_state_export
debug_verify_blocks debug_verify_column_bindings debug_verify_serializer
debug_verify_statement debug_verify_stats debug_verify_vector
debug_window_mode default_block_size default_collation default_io_mode
default_secret_storage default_transaction_invalidation_policy
delim_join_as_cte deprecated_using_key_syntax dialect_compatibility_mode
disable_database_invalidation disable_timestamptz_casts
disabled_compression_methods disabled_filesystems disabled_log_types
duckdb_api dynamic_or_filter_threshold enable_caching_operators
enable_external_access enable_external_file_cache enable_fsst_vectors
enable_http_metadata_cache enable_logging enable_optimistic_write
enable_optimizer enable_progress_bar_print enable_view_dependencies
enabled_log_types errors_as_json experimental_metadata_reuse
extension_directories extension_directory
external_file_cache_local_block_size external_file_cache_remote_block_size
external_threads file_search_path force_bitpacking_mode
force_column_metadata_reuse force_compression force_mbedtls_unsafe
force_update_to_del_and_insert force_variant_shredding
geometry_minimum_shredding_size home_directory http_proxy
http_proxy_password http_proxy_username ieee_floating_point_ops
ignore_unknown_crs immediate_transaction_mode index_scan_max_count
index_scan_percentage initial_column_segment_size integer_division
lambda_syntax late_materialization_max_rows legacy_disable_null_type
legacy_metrics_format lock_configuration log_query_path logging_level
logging_mode logging_storage max_execution_time max_temp_directory_size
max_vacuum_tasks merge_join_threshold nested_loop_join_threshold
old_implicit_casting operator_memory_limit order_by_non_integer_literal
ordered_aggregate_threshold parallelize_sequential_sources
partitioned_write_flush_threshold partitioned_write_max_open_files password
perfect_ht_threshold pin_threads pivot_filter_threshold pivot_limit
prefer_range_joins preserve_identifier_case produce_arrow_string_view
profiling_coverage profiling_mode profiling_output
profiling_renderer_settings progress_bar_time read_ahead_depth
regex_match_operator_semantics scalar_subquery_error_on_multiple_rows
scheduler_process_partial schema search_path secret_directory
standard_vector_size storage_block_prefetch streaming_buffer_size
table_function_identifier_conversion temp_file_encryption tracked_metrics
username vacuum_rebuild_indexes validate_external_file_cache
variant_minimum_shredding_size wal_autocheckpoint_entries warnings_as_errors
write_buffer_row_group_count write_buffer_row_group_memory_limit
zstd_min_string_length
""".split())

# DuckDB's other names for a setting (settings.json 'aliases')
SETTING_ALIASES = {
    "wal_autocheckpoint": "checkpoint_threshold",
    "custom_profiling_settings": "configure_profiling",
    "configure_metrics": "configure_profiling",
    "null_order": "default_null_order",
    "max_memory": "memory_limit",
    "profile_output": "profiling_output",
    "worker_threads": "threads",
    "user": "username",
}


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


class SettingsManager:
    """One connection's setting values. The memory limit is process-wide,
    as the device buffer pool is (catalog.POOL)."""

    def __init__(self):
        self.values: Dict[str, object] = {s.name: s.default for s in SETTINGS}

    @staticmethod
    def _canon(name: str) -> str:
        name = name.lower()
        if name in BY_NAME:
            return name
        return SETTING_ALIASES.get(name, name)

    def _wired(self, name: str) -> str:
        from duckdb_tpu_torch.planner.bound import not_ported

        name = self._canon(name)
        if name in NOT_PORTED:
            raise not_ported(f'the setting "{name}" (ROADMAP item 36)')
        if name not in BY_NAME:
            raise ValueError(f'unrecognized configuration parameter "{name}"')
        return name

    def set(self, name: str, value):
        name = self._wired(name)
        if BY_NAME[name].typ == "BOOLEAN" and not isinstance(value, bool):
            value = str(value).lower() in ("true", "on", "1")
        elif name == "checkpoint_threshold":
            parse_bytes(value)  # a size, or it raises
        elif name == "debug_checkpoint_abort":
            from duckdb_tpu_torch.storage.persist import ABORT_POINTS

            value = str(value).lower()
            if value not in ("none",) + ABORT_POINTS:
                raise ValueError(f"debug_checkpoint_abort takes none, {', '.join(ABORT_POINTS)}"
                                 f', got "{value}"')
        elif BY_NAME[name].typ == "BIGINT":
            try:
                value = int(value)
            except (TypeError, ValueError):
                raise ValueError(f'{name} takes an integer, got "{value}"') from None
            if value < 0:
                raise ValueError(f"{name} cannot be negative")
        self._apply(name, value)

    def reset(self, name: str):
        name = self._wired(name)
        self._apply(name, BY_NAME[name].default)

    def _apply(self, name: str, value):
        if name == "memory_limit":
            from duckdb_tpu_torch.catalog.catalog import set_memory_limit

            set_memory_limit(parse_bytes(value))
        self.values[name] = value

    def get(self, name: str, default=None):
        return self.values.get(self._canon(name), default)
