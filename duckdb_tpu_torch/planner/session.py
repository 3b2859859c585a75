"""The session state that scalar functions read while a statement runs.

Each Connection owns one Session: the names current_database() and
current_schema() report, the text of the statement running
(current_query()), the transaction counter of txid_current(), and the
torch.Generator per device that random(), the uuid family and setseed()
share, and the catalog the statement reads (its macros, user types and
sequences). `Connection.sql` makes its Session the active one for the
statement (`activate`); a function's impl reads it with `active()` when it
runs, so a cached plan reads the state of the call that runs it.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import random as _random

import torch

# the Session of the statement running in this context (None outside one)
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("duckdb_tpu_torch_session",
                                                         default=None)
_CONNECTION_IDS = itertools.count(1)


class Session:
    def __init__(self, database: str = "memory", schema: str = "main"):
        self.database = database
        self.schema = schema
        self.query = ""
        self.connection_id = next(_CONNECTION_IDS)
        self._txids = itertools.count(1001)
        self._generators: dict = {}  # str(device) → torch.Generator
        self._seed = None  # set by setseed(): every generator starts from it
        # () → the catalog the statement reads (a transaction's snapshot
        # inside BEGIN … COMMIT): its macros, user types and sequences
        self.catalog_of = None

    @property
    def catalog(self):
        return None if self.catalog_of is None else self.catalog_of()

    def next_txid(self) -> int:
        return next(self._txids)

    def generator(self, device, replay_rng=None) -> torch.Generator:
        """The generator of `device`: seeded from setseed()'s seed, else
        from `replay_rng` (a random.Random) when given, else at random."""
        key = str(device)
        g = self._generators.get(key)
        if g is None:
            g = torch.Generator(device=device)
            if self._seed is not None:
                g.manual_seed(self._seed)
            else:
                g.manual_seed((replay_rng or _random).getrandbits(63))
            self._generators[key] = g
        return g

    def set_seed(self, seed: float):
        """setseed(x), x in [-1, 1]: every generator restarts from x."""
        if not -1.0 <= seed <= 1.0:
            raise ValueError("Invalid Input Error: SETSEED accepts seed values between "
                             "-1.0 and 1.0, inclusive")
        self._seed = int((seed + 1.0) * (2**31 - 1))
        for g in self._generators.values():
            g.manual_seed(self._seed)


@contextlib.contextmanager
def activate(session: Session, query: str):
    """Run a statement with `session` active and `query` as its text."""
    session.query = query
    token = _ACTIVE.set(session)
    try:
        yield session
    finally:
        _ACTIVE.reset(token)


def current():
    """The Session of the statement running, or None outside one."""
    return _ACTIVE.get()


def active() -> Session:
    s = _ACTIVE.get()
    if s is None:
        raise RuntimeError("no statement is running: session state is read only inside "
                           "Connection.sql")
    return s
