"""Systems under test.

The framework needs a pluggable SUT boundary shaped like the reference's
TestStateMachine.receive + sync client API (SURVEY.md §2.3 end). Two
implementations:

  * `inmemory` — a single-copy, in-process linearizable SUT with injectable
    latency, timeouts, pauses and kills. This is the "stub SUT" of the
    minimum end-to-end slice (SURVEY.md §7.3) and the fixture for harness
    tests (the reference's analogue is its docker localhost flow, §4).
  * `native/` (C++ raft server + TCP wire protocol, separate top-level
    dir) — the real distributed SUT, connected via the same connection
    interfaces.
"""

from .inmemory import InMemoryCluster  # noqa: F401
