"""Deployment tier: run the native SUT as real OS processes.

Equivalent of the reference's node-lifecycle layer (src/jepsen/jgroups/
server.clj) — install/start/stop/kill/pause daemons, probe leaders, collect
logs. The port has the local backend:

  deploy.local  — every "node" is a local process (the §4 implication (b)
                  fake cluster: real processes, real sockets, real signals,
                  no SSH), faults injected via signals + the transport-level
                  block hook.

The reference's ssh backend (remote control over ssh/scp for real
multi-host clusters) is not ported yet; the CLI refuses ``--deploy ssh``.
"""
