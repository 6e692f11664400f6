"""Fault injection.

Equivalent surface: jepsen.nemesis + jepsen.nemesis.combined as the
reference uses them (nemesis/nemesis.clj, nemesis/membership.clj):
partition / kill / pause / membership fault packages with targeted victim
classes, schedules, and final-generator healing.
"""

from .base import Nemesis, NoopNemesis, ComposedNemesis, compose_nemeses  # noqa: F401
from .faults import KillNemesis, PartitionNemesis, PauseNemesis  # noqa: F401
from .membership import GrowUntilFull, MemberNemesis  # noqa: F401
from .package import (  # noqa: F401
    FAULTS,
    Package,
    SPECIALS,
    compose_packages,
    kill_package,
    member_package,
    parse_nemesis_spec,
    partition_package,
    pause_package,
    setup_nemesis,
)
from .targets import (  # noqa: F401
    complete_grudge,
    majorities_ring_grudge,
    partition_grudge,
    pick_nodes,
)
