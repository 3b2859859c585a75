"""duckdb_tpu_torch: the PyTorch/CUDA port of duckdb_tpu.

The same SQL engine as the JAX package beside it (duckdb_tpu), written in
PyTorch for an NVIDIA H100, with hand-written CUDA kernels where the JAX
package has Pallas kernels. `connect()` puts every column and
intermediate on the CUDA device unless the caller passes device="cpu".
This package imports neither jax nor duckdb_tpu.
"""

from duckdb_tpu_torch.api.connection import Connection, connect  # noqa: F401

__version__ = "0.1.0"
