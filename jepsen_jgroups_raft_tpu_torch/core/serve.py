"""Results web server.

Equivalent of the reference's `lein run serve` (raft.clj:98-101 wiring
jepsen.cli's serve-cmd): browse the store/ directory of past runs — each
run's verdict, results.json, history, timeline HTML, and collected node
logs — over plain HTTP. No framework: stdlib http.server, read-only,
path-confined to the store root.
"""

from __future__ import annotations

import html
import json
from functools import partial
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path


def _run_dirs(root: Path):
    """store/<test-name>/<timestamp>/ dirs, newest first (the reference
    store layout, SURVEY.md §2.3 history & store)."""
    runs = []
    if not root.is_dir():
        return runs
    for test_dir in sorted(root.iterdir()):
        if not test_dir.is_dir():
            continue
        for run in sorted(test_dir.iterdir(), reverse=True):
            if run.is_dir() and not run.is_symlink():  # skip latest -> …
                runs.append(run)
    runs.sort(key=lambda p: p.name, reverse=True)
    return runs


def _verdict(run: Path):
    try:
        with open(run / "results.json") as f:
            return json.load(f).get("valid?")
    except (OSError, UnicodeDecodeError, json.JSONDecodeError):
        # Exactly the ways reading a verdict can fail: missing file, or
        # a results.json truncated/corrupted mid-write (including a cut
        # inside a multi-byte UTF-8 sequence, which raises
        # UnicodeDecodeError before the JSON parser even runs).
        # Anything else is a bug that must surface, not render as "?".
        return None


def _index_html(root: Path) -> str:
    rows = []
    for run in _run_dirs(root):
        rel = run.relative_to(root)
        v = _verdict(run)
        badge = {True: "&#9989; valid", False: "&#10060; INVALID"}.get(
            v, f"? {html.escape(str(v))}")  # e.g. "unknown" verdicts
        files = " | ".join(
            f'<a href="/{rel}/{f.name}">{html.escape(f.name)}</a>'
            for f in sorted(run.iterdir()) if f.is_file())
        rows.append(f"<tr><td><code>{html.escape(str(rel))}</code></td>"
                    f"<td>{badge}</td><td>{files}</td></tr>")
    body = ("<table border=1 cellpadding=6><tr><th>run</th><th>verdict</th>"
            "<th>files</th></tr>" + "".join(rows) + "</table>"
            if rows else "<p>no runs recorded yet</p>")
    return ("<!doctype html><title>test results</title>"
            "<h1>recorded runs</h1>" + body)


class _Handler(SimpleHTTPRequestHandler):
    def __init__(self, *a, store_root: Path, **kw):
        self.store_root = store_root
        super().__init__(*a, directory=str(store_root), **kw)

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            page = _index_html(self.store_root).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(page)))
            self.end_headers()
            self.wfile.write(page)
            return
        super().do_GET()  # directory= confines paths to the store root

    def log_message(self, fmt, *args):
        pass  # quiet


def serve(store_root: str, host: str = "0.0.0.0", port: int = 8080) -> int:
    root = Path(store_root).resolve()
    httpd = ThreadingHTTPServer((host, port),
                                partial(_Handler, store_root=root))
    print(f"serving {root} on http://{host}:{port}/")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0
