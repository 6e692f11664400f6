"""Deployment tier: run the native SUT as real OS processes.

Equivalent of the reference's node-lifecycle layer (src/jepsen/jgroups/
server.clj) — install/start/stop/kill/pause daemons, probe leaders, collect
logs — with two backends, the reference's:

  deploy.local  — every "node" is a local process (the §4 implication (b)
                  fake cluster: real processes, real sockets, real signals,
                  no SSH), faults injected via signals + the transport-level
                  block hook.
  deploy.ssh    — remote control over ssh/scp subprocesses (jepsen.control
                  analogue) for real multi-host clusters (``--deploy ssh``).
"""
