"""graftlint CLI: run the project-native analyzers over the port.

Usage::

    python -m jepsen_jgroups_raft_tpu_torch.lint [paths...]
        [--rules taxonomy,sync,lock,kernel,heal,resource,...]
        [--list-rules] [--format text|json] [--baseline FILE]
        [--update-baseline]

With no paths, lints the port package and ``native/src`` of the checkout
the package lives in; the env-knob registry also reads ``chip_smoke.py``.
Each analyzer applies only to its scan set when given a directory; an
explicit single *file* argument is always analyzed by every requested
analyzer that understands its language — that is what the
seeded-violation tests (and quick one-file checks) use.

Thirteen analyzers are the JAX package's, with their scopes on this
package. Two are redesigned for PyTorch and the Hopper kernels (see
``--list-rules``): ``sync`` (:mod:`.jit_hygiene`, host syncs of card
tensors) and ``kernel`` (:mod:`.flow.kernel_contract`, the CUDA
kernels' caps, shared memory and threads). ``--format json`` emits a
SARIF 2.1.0 log. A baseline file (default ``lint/baseline.json`` when
present) suppresses accepted pre-existing findings so the gate fails
only on regression; ``--update-baseline`` rewrites it from the current
run.

Exit status: 0 clean (new findings only count), 1 new findings, 2 usage
error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

from . import jit_hygiene, lock_discipline, report, taxonomy
from .base import PACKAGE, Finding, collect_files, rel
from .flow import crashproto, degraded, envknobs, fingerprint, guarded, \
    heal, kernel_contract, knobclass, lockorder, lockstep, resource, \
    tierstamp

#: name → (module, suffixes)
ANALYZERS = {
    "taxonomy": (taxonomy, (".py",)),
    "sync": (jit_hygiene, (".py",)),
    "lock": (lock_discipline, (".h", ".cc")),
    "kernel": (kernel_contract, (".py", ".cu", ".cuh")),
    "heal": (heal, (".py",)),
    "resource": (resource, (".py",)),
    # graftsync tier: concurrency + crash-consistency
    "guarded": (guarded, (".py",)),
    "lockorder": (lockorder, (".py",)),
    "crashproto": (crashproto, (".py",)),
    "envknobs": (envknobs, (".py",)),
    # graftgate tier: verdict-integrity dataflow
    "fingerprint": (fingerprint, (".py",)),
    "degraded": (degraded, (".py",)),
    "knobclass": (knobclass, (".py",)),
    "tierstamp": (tierstamp, (".py",)),
    "lockstep": (lockstep, (".py",)),
}

RULES = {
    "taxonomy": ("taxonomy-bare-except-fail", "taxonomy-indefinite-fail",
                 "taxonomy-silent-swallow"),
    "sync": ("host-sync",),
    "lock": ("lock-guarded-field", "lock-unknown-mutex"),
    "kernel": ("kernel-cap-drift", "kernel-smem-budget", "kernel-threads",
               "kernel-unresolved"),
    "heal": ("flow-unhealed-fault",),
    "resource": ("flow-resource-leak",),
    "guarded": ("flow-unguarded-access",),
    "lockorder": ("flow-lock-cycle", "flow-lock-order",
                  "flow-lock-unranked"),
    "crashproto": ("flow-fsync-before-ack", "flow-inplace-publish",
                   "flow-nonatomic-publish"),
    "envknobs": ("flow-env-raw-parse", "flow-env-undocumented",
                 "flow-env-dup-default"),
    "fingerprint": ("flow-fp-unhashed", "flow-fp-rung-mismatch"),
    "degraded": ("flow-degraded-sink",),
    "knobclass": ("flow-knob-unclassified", "flow-knob-verdict"),
    "tierstamp": ("flow-tier-unstamped",),
    "lockstep": ("flow-lockstep-drift", "flow-lockstep-anchor"),
}

#: The analyzers redesigned for the port: name → (the JAX package's
#: analyzer, its rules that have no counterpart here, what took their
#: place). Every other analyzer is the JAX package's, re-scoped.
REDESIGNED = {
    "sync": ("jit", ("jit-host-sync", "jit-python-branch",
                     "jit-recompile-hazard"),
             "host syncs of card tensors (.item/.cpu/.tolist/.numpy, "
             "synchronize, int/float/bool of a tensor) on the hot path; "
             "`host-sync` keeps its id and pragma"),
    "kernel": ("kernel", ("kernel-block-divide", "kernel-grid-cover",
                          "kernel-block-tile", "kernel-dtype",
                          "kernel-vmem-budget"),
               "the Hopper kernels' contract: C++ caps against the "
               "Python constants, dynamic shared memory over the legal "
               "domain, launch bounds and block sizes"),
}

#: The README section that documents the port's lint (SARIF helpUri).
README_LINT = "README.md#graftlint-on-the-port"

#: rule id → README anchor for SARIF helpUri: the port's lint section,
#: by tier.
RULE_HELP = {
    **{r: f"{README_LINT}-soundness-invariants"
       for a in ("taxonomy", "sync", "lock") for r in RULES[a]},
    **{r: f"{README_LINT}-flow-invariants"
       for a in ("kernel", "heal", "resource") for r in RULES[a]},
    **{r: f"{README_LINT}-concurrency-and-crash-consistency"
       for a in ("guarded", "lockorder", "crashproto", "envknobs")
       for r in RULES[a]},
    **{r: f"{README_LINT}-verdict-integrity"
       for a in ("fingerprint", "degraded", "knobclass", "tierstamp",
                 "lockstep")
       for r in RULES[a]},
}

DEFAULT_RULES = ("taxonomy,sync,lock,kernel,heal,resource,"
                 "guarded,lockorder,crashproto,envknobs,"
                 "fingerprint,degraded,knobclass,tierstamp,lockstep")


def repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


def default_baseline() -> Path:
    return Path(__file__).resolve().parent / "baseline.json"


def run(paths: List[str], rules: List[str],
        timings: Optional[dict] = None) -> List[Finding]:
    root = repo_root()
    explicit = {Path(p).resolve() for p in paths if Path(p).is_file()}
    findings: List[Finding] = []
    for name in rules:
        t0 = time.perf_counter()
        mod, suffixes = ANALYZERS[name]
        for f in collect_files(paths, suffixes):
            relpath = rel(f, root)
            if not (Path(f).resolve() in explicit or
                    mod.applies_to(relpath)):
                continue
            for finding in mod.analyze_file(f):
                # honor the finding's own path when the analyzer looked
                # beyond the anchor file (lockorder loads the whole
                # service/ tier from daemon.py)
                findings.append(Finding(rel(finding.path, root),
                                        finding.line, finding.rule,
                                        finding.message))
        if timings is not None:
            timings[name] = timings.get(name, 0.0) + \
                (time.perf_counter() - t0)
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m jepsen_jgroups_raft_tpu_torch.lint",
        description="graftlint on the port: checker-soundness, host-sync, "
                    "native lock-discipline and CFG/dataflow (kernel-"
                    "contract, fault-heal, resource-leak, concurrency, "
                    "verdict-integrity) analysis")
    parser.add_argument("paths", nargs="*",
                        help="files or directories (default: the repo)")
    parser.add_argument("--rules", default=DEFAULT_RULES,
                        help="comma-separated analyzer subset")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text",
                        help="text (default) or SARIF 2.1.0 JSON")
    parser.add_argument("--baseline", default=None, metavar="FILE",
                        help="baseline file of accepted findings "
                             "(default: lint/baseline.json when present)")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite the baseline from this run's "
                             "findings and exit 0")
    parser.add_argument("--knob-registry", default=None, metavar="FILE",
                        help="write the JGRAFT_* env-knob registry "
                             "harvested by the envknobs analyzer as "
                             "JSON to FILE")
    parser.add_argument("--timing", action="store_true",
                        help="emit per-analyzer wall seconds to stderr")
    args = parser.parse_args(argv)

    if args.list_rules:
        for analyzer, rules in RULES.items():
            for r in rules:
                print(f"{analyzer}: {r}")
        for analyzer, (was, gone, now) in REDESIGNED.items():
            print(f"redesigned: {analyzer} (the JAX package's `{was}`): "
                  f"{now}; no counterpart for {', '.join(gone)}")
        return 0

    rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    unknown = [r for r in rules if r not in ANALYZERS]
    if unknown:
        print(f"unknown analyzer(s): {', '.join(unknown)} "
              f"(have: {', '.join(ANALYZERS)})", file=sys.stderr)
        return 2

    # A typo'd path must be a loud usage error, not a silent clean pass.
    missing = [p for p in args.paths if not Path(p).exists()]
    if missing:
        print(f"no such path(s): {', '.join(missing)}", file=sys.stderr)
        return 2

    paths = args.paths or [str(repo_root() / PACKAGE),
                           str(repo_root() / "native" / "src")]
    timings: Optional[dict] = {} if args.timing else None
    findings = run(paths, rules, timings=timings)

    # The knob registry is a whole-package harvest (it also covers
    # chip_smoke.py, which the per-file walk does not visit) — run it
    # on any default-path envknobs run, and whenever the artifact is
    # requested explicitly.
    if args.knob_registry or ("envknobs" in rules and not args.paths):
        registry, extra = envknobs.build_registry(repo_root())
        if "envknobs" in rules and not args.paths:
            findings = sorted(findings + extra,
                              key=lambda f: (f.path, f.line, f.rule))
        if args.knob_registry:
            Path(args.knob_registry).write_text(
                json.dumps(registry, indent=2, sort_keys=True) + "\n",
                encoding="utf-8")
            print(f"env-knob registry: {len(registry['knobs'])} knob(s) "
                  f"-> {args.knob_registry}", file=sys.stderr)

    if timings is not None:
        for name in sorted(timings, key=timings.get, reverse=True):
            print(f"lint-timing: {name} {timings[name]:.3f}s",
                  file=sys.stderr)
        print(f"lint-timing: total {sum(timings.values()):.3f}s",
              file=sys.stderr)

    fps = report.fingerprints(findings, repo_root())
    baseline_path: Optional[Path] = (
        Path(args.baseline) if args.baseline else default_baseline())
    if args.update_baseline:
        new_fps = {fp for _, fp in fps}
        # A partial run (analyzer subset or explicit paths) only SAW part
        # of the repo: rewriting from it would silently drop every
        # accepted fingerprint outside the run's scope, so merge instead.
        # Only the full default run is authoritative enough to prune.
        partial = bool(args.paths) or set(rules) != set(ANALYZERS)
        if partial:
            new_fps |= report.load_baseline(baseline_path)
        report.save_baseline(baseline_path, sorted(new_fps))
        print(f"baseline: wrote {len(new_fps)} finding(s) to "
              f"{baseline_path}"
              + (" (partial run: merged with existing)" if partial else ""),
              file=sys.stderr)
        return 0
    baseline = report.load_baseline(baseline_path)
    suppressed = [fp in baseline for _, fp in fps]
    new = [f for f, sup in zip(findings, suppressed) if not sup]

    if args.format == "json":
        rule_ids = [r for a in rules for r in RULES[a]]
        print(json.dumps(report.to_sarif(findings, suppressed, rule_ids,
                                         rule_help=RULE_HELP),
                         indent=2))
    else:
        for f in new:
            print(f.render())

    n_base = sum(suppressed)
    if new:
        print(f"graftlint: {len(new)} new finding(s)"
              + (f" ({n_base} baselined)" if n_base else ""),
              file=sys.stderr)
        return 1
    tail = f" — {n_base} baselined finding(s)" if n_base else ""
    print(f"graftlint: clean ({', '.join(rules)}){tail}",
          file=sys.stderr if args.format == "json" else sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
