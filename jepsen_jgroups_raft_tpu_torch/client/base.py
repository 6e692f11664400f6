"""Client protocol.

Equivalent of jepsen.client/Client as the reference's workloads implement it
(reference register.clj:53-89, counter.clj:61-98, leader.clj:24-45):

  open(test, node)    — bind a fresh client instance to one node; called
                        once per worker thread. Returns the bound client.
  setup(test)         — one-time data-plane setup after open.
  invoke(test, op)    — execute one operation synchronously; return the
                        completed op (type ok/fail/info, value filled in).
                        Implementations raise client errors; the worker
                        wraps invoke in `with_errors` to apply the
                        definite/indefinite taxonomy.
  teardown(test)      — undo setup.
  close(test)         — release the connection.
"""

from __future__ import annotations

from ..history.ops import Op


class Client:
    def open(self, test: dict, node: str) -> "Client":
        return self

    def setup(self, test: dict) -> None:
        return None

    def invoke(self, test: dict, op: Op) -> Op:
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        return None

    def close(self, test: dict) -> None:
        return None
