from duckdb_tpu_torch.catalog.catalog import Catalog, ColumnDef, TableEntry  # noqa: F401
