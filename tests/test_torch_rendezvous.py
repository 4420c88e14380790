"""How the port's multi-process runs meet (``tests/torch_rendezvous.py``).

A run's rendezvous port used to be chosen by binding port 0, reading the
number and closing the socket; rank 0 bound it again seconds later. In
between, a listener that accepts connections and never answers (as another
test's gRPC coordinator may) can take the port: rank 0 then cannot host the
store and rank 1 waits on the listener. Here that happens on purpose, and
the held rendezvous is shown to leave no such gap: its port cannot be bound
by anyone while the run is live, and the same run passes.
"""

import errno
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from torch_rendezvous import HOST, HeldRendezvous

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 5  # the children's --timeout
DEMO = ["-m", "dla_tpu_torch.parallel.multihost", "--nproc", "2", "--p", "2", "--q", "4",
        "--plane", "block", "--n", "64", "--nb", "8", "--device", "cpu", "--backend", "gloo",
        "--timeout", str(TIMEOUT)]
ENV = dict(os.environ, OMP_NUM_THREADS="1")


class _Squatter:
    """A listener on ``port`` that accepts every connection and never answers."""

    def __init__(self, port: int):
        self.sock = socket.socket()
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.sock.bind((HOST, port))
            self.sock.listen(16)
        except OSError:
            self.sock.close()
            raise
        self.accepted = []
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                self.accepted.append(self.sock.accept()[0])
            except OSError:
                return

    def close(self):
        for c in self.accepted:
            c.close()
        self.sock.close()


def _bind(family, addr, port, option):
    s = socket.socket(family)
    try:
        s.setsockopt(socket.SOL_SOCKET, option, 1)
        s.bind((addr, port))
        s.listen(1)
    finally:
        s.close()


def _wait(procs, deadline):
    """(return codes, outputs): a child still running at the deadline is
    killed and counts as None."""
    rcs, outs = [], []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=max(0.1, deadline - time.monotonic()))[0])
            rcs.append(p.returncode)
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0])
            rcs.append(None)
    return rcs, outs


@pytest.mark.parametrize("option", ["SO_REUSEADDR", "SO_REUSEPORT"])
@pytest.mark.parametrize("family,addr", [(socket.AF_INET, HOST), (socket.AF_INET, "0.0.0.0"),
                                         (socket.AF_INET6, "::1"), (socket.AF_INET6, "::")],
                         ids=["loopback", "any", "loopback6", "any6"])
def test_the_held_port_cannot_be_bound(family, addr, option):
    with HeldRendezvous(2) as rdv:
        with pytest.raises(OSError) as err:
            _bind(family, addr, rdv.port, getattr(socket, option))
        assert err.value.errno == errno.EADDRINUSE
    _bind(socket.AF_INET, HOST, rdv.port, socket.SO_REUSEADDR)  # closed: free again


def test_a_listener_on_a_bind_and_close_port_fails_the_run():
    """The old way: the port is free between being chosen and rank 0's bind.
    A listener that takes it first leaves rank 0 unable to host the store
    (EADDRINUSE) and rank 1 connected to the listener, waiting past its own
    timeout: the run fails."""
    with socket.socket() as s:
        s.bind((HOST, 0))
        port = s.getsockname()[1]
    squatter = _Squatter(port)
    try:
        procs = [subprocess.Popen([sys.executable, *DEMO, "--coordinator", f"{HOST}:{port}",
                                   "--pid", str(pid)], cwd=REPO, env=ENV, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
        rcs, outs = _wait(procs[:1], time.monotonic() + 60)
        rc1, out1 = _wait(procs[1:], time.monotonic() + 2 * TIMEOUT)  # twice its timeout
        rcs, outs = rcs + rc1, outs + out1
    finally:
        squatter.close()
    assert rcs[0] not in (0, None) and "EADDRINUSE" in outs[0], outs[0]
    assert rcs[1] != 0 and "PASS" not in outs[1], outs[1]
    assert squatter.accepted  # rank 1 reached the listener


def test_a_held_rendezvous_leaves_no_gap():
    """The same run on a held rendezvous: a listener cannot take the port
    while the run is live, and the run passes its gate."""
    with HeldRendezvous(2) as rdv:
        procs = rdv.start(DEMO, (0, 1), cwd=REPO, env=ENV)
        with pytest.raises(OSError) as err:
            _Squatter(rdv.port)
        assert err.value.errno == errno.EADDRINUSE
        rcs, outs = _wait(procs, time.monotonic() + 60)
    assert rcs == [0, 0], outs
    assert "[mh 0] 2 processes, 8 global members (4 local) on cpu, backend gloo" in outs[0]
    assert "||A - LL^T||_inf / ||A||_inf = " in outs[0] and outs[0].count(" PASS") == 1
