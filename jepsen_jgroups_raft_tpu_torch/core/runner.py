"""The test interpreter.

Equivalent of jepsen.core/run! (reference L0; composed at raft.clj:54-92):

  1. set up the DB (SUT node lifecycle) on every node concurrently,
  2. spawn `concurrency` client worker threads (each bound round-robin to a
     node, each with its own client connection) plus one nemesis thread,
  3. drive them from the generator under a scheduler lock, recording every
     invocation/completion into the history with ns timestamps and dense
     indices,
  4. process-id bookkeeping: a worker whose op ends `info` (indefinite —
     the op may still execute server-side) retires its process id and
     continues as `process + concurrency` with a fresh client connection,
     exactly jepsen's crashed-process rule — this is what makes the
     history's forever-concurrent semantics true,
  5. tear down, run the composed checker over the history, persist to
     store/.

Wall-clock concurrency is host-side Python threading (the reference's
worker threads, SURVEY.md §2.4 row 1): these threads spend their lives
blocked on sockets, so the GIL is irrelevant; the compute-heavy part (the
checker) runs on the card afterwards.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..client.errors import with_errors
from ..generator.base import NEMESIS_THREAD, PENDING, Generator, to_gen
from ..history.ops import INFO, INVOKE, NEMESIS, History, Op
from .store import prepare_dir, save_test

LOG = logging.getLogger("jgraft.core")

#: seconds between generator polls when PENDING.
POLL_INTERVAL = 0.002

#: default ops per live-stream segment (`live_stream` test key).
LIVE_STREAM_FLUSH_OPS = 64


class _LiveStreamFeeder:
    """Producer side of a streaming verdict session: a
    running test streams its client ops to graftd AS THEY COMPLETE, so
    the checker acts as a live monitor instead of a postmortem tool.

    `record()` is called under the history lock and must stay O(1): it
    buffers the op dict and hands full segments to a feeder thread,
    which appends them over HTTP with the client's idempotent
    per-segment retry. Every failure is absorbed (logged once, feeder
    disabled) — live streaming is an OBSERVER; it must never stall or
    kill the run it watches."""

    def __init__(self, cfg: dict):
        from ..service.client import ServiceClient, StreamSession

        self.flush_ops = int(cfg.get("flush_ops", LIVE_STREAM_FLUSH_OPS))
        client = ServiceClient(cfg["url"],
                               timeout=float(cfg.get("timeout_s", 30.0)))
        self.session = StreamSession(
            client, workload=cfg.get("workload", "register"),
            algorithm=cfg.get("algorithm", "auto"),
            binary=bool(cfg.get("binary", False)))
        self.session.open()
        self._buf: list = []
        self._q: list = []
        self._cond = threading.Condition()
        self._dead = False
        self._closing = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="live-stream")
        self._thread.start()

    def record(self, op) -> None:
        if self._dead or op.process == NEMESIS:
            return
        self._buf.append(op.to_dict())
        if len(self._buf) >= self.flush_ops:
            buf, self._buf = self._buf, []
            with self._cond:
                self._q.append(buf)
                self._cond.notify()

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._closing:
                    self._cond.wait(0.2)
                if not self._q and self._closing:
                    return
                seg = self._q.pop(0)
            try:
                self.session.append(seg)
            except Exception:
                LOG.exception("live-stream append failed; streaming "
                              "disabled for this run")
                self._dead = True
                with self._cond:
                    self._q.clear()
                return

    def close(self) -> Optional[dict]:
        """Flush the tail, finish the session, return the final stream
        record (None when streaming died mid-run)."""
        if self._buf and not self._dead:
            with self._cond:
                self._q.append(self._buf)
        self._buf = []
        with self._cond:
            self._closing = True
            self._cond.notify()
        self._thread.join(60.0)
        if self._dead:
            return None
        try:
            return self.session.finish()
        except Exception:
            LOG.exception("live-stream finish failed")
            return None


def _open_client(proto, test: dict, node: str):
    """open + setup as ONE acquisition: when setup raises, the half-open
    connection is closed before the error propagates. Before this
    (graftcheck flow-resource-leak finding), every worker whose setup
    failed dropped an open socket on the floor — invisible per run,
    fd exhaustion across a long hell campaign."""
    client = proto.open(test, node)
    try:
        client.setup(test)
    except BaseException:
        try:
            client.close(test)
        except Exception:
            LOG.debug("close of half-open client failed", exc_info=True)
        raise
    return client


class Scheduler:
    """Serializes generator access across workers; owns test time."""

    def __init__(self, gen, test: dict):
        self.gen: Optional[Generator] = to_gen(gen)
        self.test = test
        self.lock = threading.Lock()
        self.t0 = time.monotonic_ns()
        self.busy = 0

    def now(self) -> int:
        return time.monotonic_ns() - self.t0

    def next_op(self, thread) -> Optional[dict]:
        """Block until an op is available for `thread`, or None when the
        generator is exhausted."""
        while True:
            with self.lock:
                if self.gen is None:
                    return None
                ctx = {"time": self.now(), "thread": thread, "busy": self.busy}
                r = self.gen.op(self.test, ctx)
                if r is None:
                    self.gen = None
                    return None
                op, g2 = r
                self.gen = g2
                if op != PENDING:
                    self.busy += 1
                    return op
            time.sleep(POLL_INTERVAL)

    def complete(self, event: Op) -> None:
        with self.lock:
            self.busy -= 1
            if self.gen is not None:
                ctx = {"time": self.now(), "thread": None, "busy": self.busy}
                self.gen = self.gen.update(self.test, ctx, event)


def run_test(test: dict) -> dict:
    """Run a test map; returns it with :history and :results filled in.

    Recognized keys (jepsen test-map equivalents, raft.clj:54-92):
      name, nodes, concurrency, client (Client), nemesis (Nemesis),
      generator, checker (Checker), db (DB), members (mutable set — the
      shared membership atom raft.clj:70), idempotent (op f's safe to fail
      on indefinite errors), store (bool).
    """

    test = dict(test)
    test.setdefault("name", "test")
    test.setdefault("nodes", [f"n{i}" for i in range(1, 6)])
    test.setdefault("concurrency", 5)
    test.setdefault("idempotent", set())
    if "members" not in test or test["members"] is None:
        test["members"] = set(test["nodes"])
    test.setdefault("start_time", time.time())

    history = History()
    hlock = threading.Lock()

    # Live streaming: `live_stream` is either a config dict
    # ({"url": "http://host:port" | "unix:/path.sock", "workload"?,
    # "flush_ops"?, "binary"?}) or a
    # ready feeder-like object with record/close. A feeder that fails
    # to OPEN degrades to no streaming — the run must not depend on the
    # monitor being up.
    feeder = None
    live_cfg = test.get("live_stream")
    if live_cfg is not None:
        try:
            feeder = (live_cfg if hasattr(live_cfg, "record")
                      else _LiveStreamFeeder(dict(live_cfg)))
        except Exception:
            LOG.exception("live-stream open failed; running without a "
                          "live monitor")
            feeder = None

    def record(op: Op) -> Op:
        with hlock:
            op.time = sched.now()
            history.append(op)  # assigns index
            if feeder is not None:
                feeder.record(op)
            return op

    db = test.get("db")
    if db is not None:
        LOG.info("setting up DB on %s", test["nodes"])
        with ThreadPoolExecutor(len(test["nodes"])) as ex:
            list(ex.map(lambda n: db.setup(test, n), test["nodes"]))

    sched = Scheduler(test.get("generator"), test)
    concurrency = int(test["concurrency"])

    def client_worker(i: int) -> None:
        process = i
        node = test["nodes"][i % len(test["nodes"])]
        proto = test.get("client")
        client = None
        if proto is not None:
            # A connect failure at startup must not kill the worker: the
            # loop below retries per-op and records :fail until it heals
            # (otherwise the generator never drains and run_test hangs).
            try:
                client = _open_client(proto, test, node)
            except Exception:
                LOG.exception("worker %d: initial open failed; will retry", i)
                client = None
        try:
            while True:
                opd = sched.next_op(i)
                if opd is None:
                    return
                inv = Op(process=process, type=INVOKE, f=opd["f"],
                         value=opd.get("value"))
                record(inv)
                if proto is not None and client is None:
                    # Previous reconnect failed; retry before invoking.
                    # (_open_client: a failed setup must leave client
                    # None AND closed, not a half-open object the next
                    # invoke would use.)
                    try:
                        client = _open_client(proto, test, node)
                    except Exception:
                        LOG.exception("worker %d: reconnect failed", i)
                        client = None
                if proto is None:
                    comp = inv.replace(type="ok")
                elif client is None:
                    comp = inv.replace(type="fail",
                                       error="connect: reconnect failed")
                else:
                    try:
                        comp = with_errors(
                            lambda t, o: client.invoke(t, o), test,
                            inv.replace(), test["idempotent"])
                    except Exception as e:
                        # Non-client exception (a bug in the client or
                        # workload): never kill the worker silently —
                        # record it as an indefinite crash, like jepsen.
                        LOG.exception("worker %d: invoke raised", i)
                        comp = inv.replace(type=INFO, error=repr(e))
                comp.process = process
                comp = comp.replace(index=-1)
                record(comp)
                sched.complete(comp)
                if comp.type == INFO:
                    # Crashed process: a fresh identity + connection
                    # (jepsen's thread->process remapping).
                    process += concurrency
                    if client is not None:
                        try:
                            client.close(test)
                        except Exception:
                            LOG.debug("worker %d: close after info op "
                                      "failed", i, exc_info=True)
                        try:
                            client = _open_client(proto, test, node)
                        except Exception:
                            LOG.exception(
                                "worker %d: reopen failed; will retry", i)
                            client = None
        finally:
            if client is not None:
                # teardown and close are SEPARATE obligations: a raising
                # teardown used to skip close entirely (graftcheck
                # flow-resource-leak finding), leaking the socket of
                # every worker whose workload teardown failed.
                try:
                    client.teardown(test)
                except Exception:
                    LOG.exception("client teardown failed (node %s)", node)
                finally:
                    try:
                        client.close(test)
                    except Exception:
                        LOG.debug("client close failed (node %s)", node,
                                  exc_info=True)

    def nemesis_worker() -> None:
        # Always run the nemesis loop: with no nemesis configured, a noop
        # one drains any nemesis-routed ops (otherwise the generator would
        # never exhaust and client workers would spin forever).
        from ..nemesis.base import NoopNemesis

        nem = test.get("nemesis") or NoopNemesis()
        try:
            nem = nem.setup(test) or nem
        except Exception:
            # A failed nemesis setup must not strand the run: keep draining
            # nemesis-routed ops with a noop (annotated) nemesis.
            LOG.exception("nemesis setup failed; continuing with noop")
            nem = NoopNemesis()
        try:
            while True:
                opd = sched.next_op(NEMESIS_THREAD)
                if opd is None:
                    return
                inv = Op(process=NEMESIS, type=INFO, f=opd["f"],
                         value=opd.get("value"))
                record(inv)
                try:
                    comp = nem.invoke(test, inv.replace())
                except Exception as e:
                    LOG.exception("nemesis op %s failed", opd["f"])
                    comp = inv.replace(error=repr(e))
                comp.process = NEMESIS
                comp.type = INFO
                comp = comp.replace(index=-1)
                record(comp)
                sched.complete(comp)
        finally:
            try:
                nem.teardown(test)
            except Exception:
                LOG.exception("nemesis teardown failed")

    threads = [
        threading.Thread(target=client_worker, args=(i,), daemon=True,
                         name=f"worker-{i}")
        for i in range(concurrency)
    ]
    threads.append(
        threading.Thread(target=nemesis_worker, daemon=True, name="nemesis"))
    LOG.info("running %s: %d workers + nemesis over %s",
             test["name"], concurrency, test["nodes"])
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    live_result = None
    if feeder is not None:
        try:
            live_result = feeder.close()
        except Exception:
            LOG.exception("live-stream close failed")

    # Prepare the run directory BEFORE log collection so DBs that download
    # node logs (ssh tier) can place them inside this run's store dir.
    if test.get("store", True) and "store_dir" not in test:
        test["store_dir"] = prepare_dir(test)

    if db is not None:
        logs = {}
        if hasattr(db, "log_files"):
            for n in test["nodes"]:
                try:
                    logs[n] = db.log_files(test, n)
                except Exception:
                    LOG.warning("log collection failed for %s", n,
                                exc_info=True)
        test["log_files"] = logs
        with ThreadPoolExecutor(len(test["nodes"])) as ex:
            list(ex.map(lambda n: db.teardown(test, n), test["nodes"]))

    test["history"] = history
    checker = test.get("checker")
    if checker is not None:
        from ..checker.perf import format_scan_stats, format_tier_stats
        from ..checker.schedule import stats_scope

        LOG.info("checking %d-op history", len(history))
        # Per-run scan-stats scope: this run's chunked-scan counters,
        # isolated from every other run this process executes. Stamped
        # AFTER the composed check completes — the perf sub-checker runs
        # before the workload checker inside the composition, so only
        # the runner sees the run's full counters.
        with stats_scope() as scan_scope:
            test["results"] = checker.check(test, history, {})
        scan = format_scan_stats(scan_scope)
        if scan is not None and isinstance(test["results"], dict):
            test["results"].setdefault("scan-stats", scan)
        # The run's per-tier decided counts ride beside the
        # scan counters (same scope, same authoritative-after-the-
        # composed-check stance).
        tiers = format_tier_stats(
            {k: {"rows": v[0], "wall_s": v[1]}
             for k, v in scan_scope.get("tiers", {}).items()})
        if tiers is not None and isinstance(test["results"], dict):
            test["results"].setdefault("decided-tiers", tiers)
    else:
        test["results"] = {"valid?": True, "note": "no checker"}
    if live_result is not None and isinstance(test["results"], dict):
        # the streamed verdict rides beside the local checker's (they
        # agree on valid? by the §14 identity; the stream record adds
        # mid-run detection metadata — decided-at-segment etc.)
        test["results"].setdefault("live-stream", live_result)

    if test.get("store", True):
        save_test(test, history, test["results"])
    LOG.info("run complete: valid? = %s", test["results"].get("valid?"))
    return test
