"""Test orchestration of the port: the reference's `core/` — the
interpreter that drives worker threads and the nemesis thread from a
generator, records the history, runs the composed checker on the test's
device and persists the run (`runner`), test composition (`compose`),
the DB and network protocols (`db`), the results browser (`serve`) and
the store's on-disk format (`store`, byte for byte the reference's, so
stores written by either package load in the other)."""

from .compose import compose_test  # noqa: F401
from .db import DB, InMemoryDB, InMemoryNet, Net  # noqa: F401
from .runner import run_test, Scheduler  # noqa: F401
from .store import load_history, save_test, store_root  # noqa: F401
