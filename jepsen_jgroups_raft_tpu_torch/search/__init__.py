"""graftsearch — coverage-guided scenario search (the port of the
reference's `search/` package, over the port's checking service).

The checker fleet that finds its own bugs: a typed mutation-operator
registry over `history/synth.py` scenarios (`operators`), a
deterministic scenario genome + materializer (`scenario`), a fitness
function scored from signals every graftd verdict already carries
(`fitness`), a content-addressed minimized corpus under
``store/search/`` (`corpus`), the generation loop driving graftd's
batched admission (`driver`), and a seeded-violation recall harness
with a random-mutation ablation arm (`recall`).
"""

from .corpus import Corpus
from .driver import SearchConfig, SearchDriver
from .fitness import score_candidate
from .operators import REGISTRY, corrupt_once, family_of, operators_for
from .recall import RecallReport, plant_violations, run_recall
from .scenario import Scenario, materialize, scenario_fingerprint

__all__ = [
    "Corpus",
    "REGISTRY",
    "RecallReport",
    "Scenario",
    "SearchConfig",
    "SearchDriver",
    "corrupt_once",
    "family_of",
    "materialize",
    "operators_for",
    "plant_violations",
    "run_recall",
    "scenario_fingerprint",
    "score_candidate",
]
