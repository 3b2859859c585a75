"""Typed error taxonomy.

Mirrors the reference's exception hierarchy
(duckdb/src/common/exception.cpp, ~30 types; message prefixes
"Out of Range Error:", "Conversion Error:", "Binder Error:", ... are the
reference's rendered forms). Existing engine errors (BindError,
ParserError, ConnectionException) remain; this module adds the typed
value-error family and is the stable import surface:

    from duckdb_tpu_torch.errors import OutOfRangeException, ConversionException
"""

from __future__ import annotations


class ConnectionException(Exception):
    """A statement the connection refuses: a catalog object that exists
    or does not, a violated constraint (the JAX package's
    duckdb_tpu/api/connection.py raises this class for all of them)."""


class TransactionException(ConnectionException):
    """BEGIN / COMMIT / ROLLBACK out of turn, or a commit that lost a
    write-write conflict."""


class Error(Exception):
    """Base of all engine errors (reference: duckdb::Exception)."""

    prefix = ""

    def __init__(self, msg: str):
        if self.prefix and not msg.startswith(self.prefix):
            msg = f"{self.prefix}{msg}"
        super().__init__(msg)


class OutOfRangeException(Error):
    """Arithmetic/cast value outside the target type's range
    (reference: OutOfRangeException, exception.cpp)."""

    prefix = "Out of Range Error: "


class ConversionException(Error):
    """Failed value conversion/cast (reference: ConversionException)."""

    prefix = "Conversion Error: "


class InvalidInputException(Error):
    prefix = "Invalid Input Error: "


class ConstraintException(Error, ConnectionException):
    """A violated NOT NULL, PRIMARY KEY, UNIQUE, CHECK or FOREIGN KEY
    constraint: DuckDB's class, and a ConnectionException, the JAX
    package's."""

    prefix = "Constraint Error: "


class CatalogException(Error, ConnectionException):
    """A catalog entry that is missing, exists already, or has entries
    that depend on it (a column an ALTER TABLE would drop from under a
    key, an index or a CHECK): DuckDB's class, and a ConnectionException,
    the JAX package's."""

    prefix = "Catalog Error: "


class NotImplementedException(Error):
    prefix = "Not implemented Error: "


class InternalException(Error):
    prefix = "INTERNAL Error: "


class SerializationException(Error):
    prefix = "Serialization Error: "


class IOException(Error):
    prefix = "IO Error: "


class OutOfMemoryException(Error):
    prefix = "Out of Memory Error: "


class SyntaxException(Error):
    prefix = "Syntax Error: "


class PermissionException(Error):
    prefix = "Permission Error: "


_INT_TYPE_NAMES = {1: "INT8", 2: "INT16", 4: "INT32", 8: "INT64"}


def int_type_name(np_dtype) -> str:
    import numpy as np

    return _INT_TYPE_NAMES.get(np.dtype(np_dtype).itemsize, "INT64")
