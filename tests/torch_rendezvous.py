"""The rendezvous of a multi-process run, held by the process that starts it.

A run's children join one ``torch.distributed`` group through the ``tcp://``
rendezvous of ``dla_tpu_torch.parallel.multihost.initialize``. Left to
itself, rank 0 hosts that rendezvous's TCPStore on the port named by
``--coordinator``, so the starting process would have to pick a free port
and let it go before rank 0 binds it, seconds later: in between, any other
process may take it (another test's server, another run's children, an
outgoing connection's ephemeral port).

:class:`HeldRendezvous` closes that gap. The starting process creates the
TCPStore itself, on a port the kernel picks (port 0), and keeps it until
every child has exited. Each child gets ``--coordinator 127.0.0.1:<port>``
and ``TORCHELASTIC_USE_AGENT_STORE=True``, with which torch's ``tcp://``
rendezvous makes every rank a client of the store at that address, rank 0
too. The port is bound from the moment it is chosen until the run ends.
A demo started by hand, without the variable, still has rank 0 host the
store.

Imports only torch (the card tests use it where JAX is absent).
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys

import torch.distributed as dist

HOST = "127.0.0.1"


class HeldRendezvous:
    """A TCPStore for ``world_size`` children, held in this process until
    :meth:`close` (or the end of a ``with`` block)."""

    def __init__(self, world_size: int):
        self.store = dist.TCPStore(HOST, 0, world_size, is_master=True, wait_for_workers=False,
                                   timeout=datetime.timedelta(seconds=300))
        self.port = self.store.port
        self.coordinator = f"{HOST}:{self.port}"

    def start(self, argv: list, pids, *, cwd, env: dict | None = None) -> list:
        """One child per pid, ``python argv --coordinator <held> --pid <pid>``
        with ``env`` (this process's environment by default) and every rank a
        client of the held store; its output (stderr too) piped as text."""
        env = dict(os.environ if env is None else env, TORCHELASTIC_USE_AGENT_STORE="True")
        return [subprocess.Popen([sys.executable, *argv, "--coordinator", self.coordinator,
                                  "--pid", str(pid)], cwd=cwd, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
                for pid in pids]

    def close(self) -> None:
        """Stop the store's server; call once every child has exited."""
        self.store = None

    def __enter__(self) -> HeldRendezvous:
        return self

    def __exit__(self, *exc) -> None:
        self.close()
