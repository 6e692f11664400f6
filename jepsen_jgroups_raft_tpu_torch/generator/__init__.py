"""Generator algebra.

Equivalent surface: the jepsen.generator combinators the reference composes
its schedules from (SURVEY.md §2.3): phases, stagger, mix, limit,
time-limit, sleep, log, flip-flop, delay, nemesis/clients routing, plus the
`independent` concurrent-generator for multi-key workloads
(reference raft.clj:78-91, register.clj:112-117, membership.clj:105-111).

Design: generators are immutable-ish objects with
    op(test, ctx)   -> (op_dict, next_gen) | (PENDING, next_gen) | None
    update(test, ctx, event) -> next_gen
ctx carries {"time": ns_since_start, "thread": requesting thread id
("nemesis" or int)}. The interpreter (core/runner.py) polls each worker's
next op under a scheduler lock; PENDING means "nothing for you right now".
None means exhausted. Emitted ops are plain dicts {"f": ..., "value": ...}
— the interpreter assigns process ids, times, and history indices.
"""

from .base import (  # noqa: F401
    PENDING,
    Generator,
    to_gen,
    Any,
    Clients,
    Delay,
    FlipFlop,
    Limit,
    Log,
    Mix,
    NemesisGen,
    OpFn,
    Phases,
    Repeat,
    Seq,
    Sleep,
    Stagger,
    Synchronize,
    TimeLimit,
)
from .independent import ConcurrentGenerator, tuple_value  # noqa: F401
