"""Client protocol and error taxonomy.

Equivalent surface: jepsen.client/Client (open!/setup!/invoke!/teardown!/
close!) and the reference's error taxonomy (workload/client.clj).
"""

from .base import Client  # noqa: F401
from .errors import (  # noqa: F401
    ClientTimeout,
    ConnectFailed,
    NotLeader,
    SocketBroken,
    classify_error,
    with_errors,
)
