"""Result persistence of the port: the store's on-disk format
(`core/store.py`, a copy of the reference's), so stores written by either
package load in the other."""

from .store import load_history, save_test, store_root  # noqa: F401
