"""Per-process operation timeline, rendered to HTML.

A copy of the reference's checker/timeline.py. Equivalent of
jepsen.checker.timeline/html (reference register.clj:108,
counter.clj:134, leader.clj:82): one swimlane per process, one box per op
spanning invocation→completion, colored by completion type. Written into
the store directory when available.
"""

from __future__ import annotations

import html as html_mod
from pathlib import Path

from ..history.ops import FAIL, INFO, OK, History
from .base import Checker

_COLORS = {OK: "#9ce29c", FAIL: "#f5a3a3", INFO: "#ffd27f"}


class TimelineChecker(Checker):
    def __init__(self, filename: str = "timeline.html"):
        self.filename = filename

    def check(self, test, history, opts=None) -> dict:
        if not isinstance(history, History):
            history = History(history)
        doc = render_timeline(history)
        out = {"valid?": True}
        store_dir = (test or {}).get("store_dir")
        if store_dir:
            path = Path(store_dir) / self.filename
            try:
                path.write_text(doc)
                out["file"] = str(path)
            except OSError:
                pass
        else:
            out["html"] = doc
        return out


def render_timeline(history: History, px_per_s: float = 100.0,
                    highlight_index: int | None = None,
                    footer_html: str = "") -> str:
    """Render the swimlane timeline. `highlight_index` marks the op pair
    whose invoke or completion has that history index as the violating op
    (thick red outline) — counterexample rendering, the analogue of the
    anomaly graphs the reference's stack renders via graphviz
    (reference bin/docker/control/Dockerfile:13-14)."""
    pairs = history.client_ops().pairs()
    if not pairs:
        return "<html><body>empty history</body></html>"
    tmax = max((p.completion.time for p in pairs if p.completion is not None),
               default=0)
    procs = sorted({p.invoke.process for p in pairs},
                   key=lambda x: (str(type(x)), x))
    lane = {p: i for i, p in enumerate(procs)}
    rows = []
    for p in pairs:
        t0 = p.invoke.time / 1e9
        t1 = (p.completion.time if p.completion is not None else tmax) / 1e9
        typ = p.ctype
        left = 80 + t0 * px_per_s
        width = max(2.0, (t1 - t0) * px_per_s)
        top = 10 + lane[p.invoke.process] * 26
        label = html_mod.escape(
            f"{p.f} {p.invoke.value!r} -> {typ}"
            + (f" {p.completion.value!r}" if p.completion is not None else ""))
        hot = highlight_index is not None and (
            p.invoke.index == highlight_index
            or (p.completion is not None
                and p.completion.index == highlight_index))
        cls = "op bad" if hot else "op"
        rows.append(
            f"<div class='{cls}' title='{label}' style='left:{left:.0f}px;"
            f"top:{top}px;width:{width:.0f}px;"
            f"background:{_COLORS.get(typ, '#ddd')}'>{html_mod.escape(str(p.f))}"
            f"</div>")
    lanes = "".join(
        f"<div class='lane' style='top:{10 + i * 26}px'>{html_mod.escape(str(pr))}</div>"
        for pr, i in lane.items())
    height = 40 + len(procs) * 26
    return (
        "<html><head><style>"
        ".op{position:absolute;height:20px;font-size:10px;overflow:hidden;"
        "border:1px solid #555;border-radius:3px;padding:0 2px;}"
        ".op.bad{border:3px solid #c00;z-index:2;box-shadow:0 0 6px #c00;}"
        ".lane{position:absolute;left:0;width:75px;font:11px sans-serif;"
        "text-align:right;}"
        ".footer{position:absolute;left:0;font:12px sans-serif;"
        "white-space:pre-wrap;}"
        "body{position:relative;font-family:sans-serif;}"
        f"</style></head><body style='height:{height + 20}px'>"
        f"{lanes}{''.join(rows)}"
        + (f"<div class='footer' style='top:{height}px'>{footer_html}</div>"
           if footer_html else "")
        + "</body></html>")
