from duckdb_tpu_torch.blocks.column import Batch, Column, pad_bucket  # noqa: F401
