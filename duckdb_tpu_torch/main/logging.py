"""The log that duckdb_logs() reads.

As in the JAX package (duckdb_tpu/main/logging.py) and DuckDB's LogManager
(src/logging/): a ring of the last 4,096 structured entries per database,
each with its time, level, type and message; entries below `min_level`
(INFO) are dropped. Each database's catalog carries one manager, shared by
its connections. The port logs where the JAX package logs, with its types
and the first words of its messages: QueryLog once per SELECT,
MemoryPressure, Checkpoint, StringHostLoop (ops/strings.py), out_of_core
(execution/chunked.py), and sharding, exchange_join, sharded_sort,
sharded_topn and sharded_window (execution/executor.py, window_exec.py).
`SELECT * FROM duckdb_logs()` gives the columns timestamp, log_level, type
and message.
"""

from __future__ import annotations

import datetime
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque

LEVELS = ("TRACE", "DEBUG", "INFO", "WARN", "ERROR")
CAPACITY = 4096


@dataclass
class LogEntry:
    ts: float
    level: str
    log_type: str
    message: str


class LogManager:
    def __init__(self, capacity: int = CAPACITY):
        self.entries: Deque[LogEntry] = deque(maxlen=capacity)
        self.min_level = "INFO"

    def log(self, level: str, log_type: str, message: str):
        if LEVELS.index(level) >= LEVELS.index(self.min_level):
            self.entries.append(LogEntry(time.time(), level, log_type, message))

    def info(self, log_type: str, message: str):
        self.log("INFO", log_type, message)

    def debug(self, log_type: str, message: str):
        self.log("DEBUG", log_type, message)

    def warn(self, log_type: str, message: str):
        self.log("WARN", log_type, message)

    def error(self, log_type: str, message: str):
        self.log("ERROR", log_type, message)

    def rows(self):
        """(timestamp text, level, type, message) of each entry, oldest first."""
        return [(datetime.datetime.fromtimestamp(e.ts).isoformat(sep=" ", timespec="milliseconds"),
                 e.level, e.log_type, e.message) for e in self.entries]
