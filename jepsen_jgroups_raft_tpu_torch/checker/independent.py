"""Multi-key history decomposition — batched across keys (a copy of the
reference's `checker/independent.py`, on the port's checker).

Equivalent of jepsen.independent/checker (reference register.clj:106):
ops whose values are ``(key, value)`` tuples are split into per-key
sub-histories, each checked independently.

Per-key checking is not a loop over keys: the per-key sub-histories are
exactly the batch dimension the kernels run over, and batch rows never
exchange state. :func:`check_keyed` is the one home of that path: every
key's sub-history is ENCODED EXACTLY ONCE (`history.packing.
encode_history`), the encodings enter `checker.linearizable.
check_encoded` as ONE cross-key batch (the lin fast path, grouping by
window, the dense plans, the sort ladder, the host tiers and the weaker
rungs all apply unchanged), and the per-key verdicts demux back by
position — verdict-identical to K sequential checker invocations.
`IndependentLinearizable` is the Checker-protocol face of it;
`IndependentChecker` remains the generic (non-frontier) composition.
Both batched entry points take ``device`` (`platform.resolve_device`:
the card unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..history.ops import History
from ..history.packing import encode_history
from ..models.base import Model
from ..platform import resolve_device
from .base import INVALID, Checker, merge_valid
from .counterexample import attach_counterexample, write_counterexample_html
from .linearizable import DEFAULT_MAX_CPU_CONFIGS, check_encoded


def split_by_key(history: History) -> Dict:
    """Split a history of (key, value)-tupled ops into per-key histories,
    unwrapping values. Ops without tuple values raise — mixing independent
    and plain ops in one history is a bug."""
    subs: Dict = {}
    for op in history:
        if op.value is None and op.type == "invoke":
            raise ValueError(
                f"independent history contains untupled op: {op}"
            )
        key, value = op.value if op.value is not None else (None, None)
        if key is None:
            continue
        sub = subs.setdefault(key, History())
        sub.append(op.replace(value=value, index=op.index))
    return subs


def check_keyed(subs: Dict, model, algorithm: str = "auto",
                n_configs: Optional[int] = None,
                n_slots: Optional[int] = None,
                max_cpu_configs: Optional[int] = DEFAULT_MAX_CPU_CONFIGS,
                consistency: str = "linearizable", device=None) -> Dict:
    """Check per-key sub-histories as ONE cross-key `check_encoded`
    batch (module docstring) on `device`. Returns {key: result dict} in
    the input's key order."""
    dev = resolve_device(device)
    keys = list(subs.keys())
    if not keys:
        return {}
    encs = [encode_history(subs[k], model) for k in keys]
    rs = check_encoded(encs, model, algorithm, dev,
                       max_cpu_configs=max_cpu_configs, n_configs=n_configs,
                       n_slots=n_slots, consistency=consistency)
    return dict(zip(keys, rs))


class IndependentChecker(Checker):
    """Generic per-key composition: run `checker_factory()` per key.
    (Kept for NON-frontier checkers; frontier models take the batched
    `IndependentLinearizable`/`check_keyed` path instead of K sequential
    invocations.)"""

    def __init__(self, checker_factory: Callable[[], Checker]):
        self.checker_factory = checker_factory

    def check(self, test, history, opts=None) -> dict:
        if not isinstance(history, History):
            history = History(history)
        subs = split_by_key(history.client_ops())
        results = {
            str(k): self.checker_factory().check(test, sub, opts)
            for k, sub in subs.items()
        }
        return {
            "valid?": merge_valid(r.get("valid?") for r in results.values()),
            "key-count": len(subs),
            "results": results,
        }


class IndependentLinearizable(Checker):
    """Per-key linearizability (or a weaker rung) as one batched check
    over the cross-key batch axis, on `device` (resolved when built).
    An INVALID key carries the reference's counterexample, and its HTML
    timeline is written into ``test["store_dir"]`` as
    ``counterexample-<key>.html`` when there is one."""

    def __init__(self, model_factory: Callable[[], Model],
                 algorithm: str = "auto",
                 n_configs: Optional[int] = None,
                 n_slots: Optional[int] = None,
                 max_cpu_configs: Optional[int] = None,
                 consistency: str = "linearizable", device=None):
        self.model_factory = model_factory
        self.algorithm = algorithm
        self.n_configs = n_configs
        self.n_slots = n_slots
        self.max_cpu_configs = max_cpu_configs or DEFAULT_MAX_CPU_CONFIGS
        self.consistency = consistency
        self.device = resolve_device(device)

    def check(self, test, history, opts=None) -> dict:
        if not isinstance(history, History):
            history = History(history)
        subs = split_by_key(history.client_ops())
        if not subs:
            return {"valid?": True, "key-count": 0, "results": {}}
        model = self.model_factory()
        keyed = check_keyed(subs, model, self.algorithm, self.n_configs,
                            self.n_slots,
                            max_cpu_configs=self.max_cpu_configs,
                            consistency=self.consistency,
                            device=self.device)
        store_dir = (test or {}).get("store_dir")
        for k, r in keyed.items():
            if r.get("valid?") is INVALID:
                attach_counterexample(r, subs[k], model,
                                      max_cpu_configs=self.max_cpu_configs,
                                      consistency=self.consistency)
                write_counterexample_html(r, subs[k], store_dir,
                                          f"counterexample-{k}.html")
        results = {str(k): r for k, r in keyed.items()}
        return {
            "valid?": merge_valid(r.get("valid?") for r in results.values()),
            "key-count": len(keyed),
            "results": results,
        }
