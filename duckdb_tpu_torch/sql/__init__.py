from duckdb_tpu_torch.sql.parser import parse_sql

__all__ = ["parse_sql"]
