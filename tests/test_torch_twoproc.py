"""The launcher of the port's multi-process gloo tests
(``tests/_torch_twoproc.py``) against the fault it repairs.

A rendezvous port taken by ``bind(("localhost", 0))`` and closed lies in
the kernel's ephemeral range, where the kernel may give it to another
job's socket (a listener bound to port 0, an outgoing connection) before
process 0 listens; the listen then fails with ``EADDRINUSE``
(``SO_REUSEADDR`` does not help) and process 1 waits out its join
timeout. Here the port is taken by a connection on purpose:

- a gloo pair given such a port fails (process 0's ``EADDRINUSE``) when
  no retry is allowed, and is stopped at once, not at process 1's join
  timeout;
- :func:`run_procs` runs the pair once more on a fresh port and both
  processes join and reduce;
- :func:`free_port` picks ports below the ephemeral range, which no
  outgoing connection is given, bindable and distinct.
"""

from __future__ import annotations

import os
import socket
import sys
import time

from _torch_twoproc import (
    _ephemeral_low,
    bind_failed,
    free_port,
    free_ports,
    run_procs,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PAIR = """
import sys
sys.path.insert(0, {repo!r})
import torch
port, pid = sys.argv[1], int(sys.argv[2])
from mpitree_tpu_torch.parallel import distributed
distributed.initialize(f"localhost:{{port}}", 2, pid, backend="gloo",
                       timeout=60)
import torch.distributed as dist
t = torch.tensor([float(pid + 1)])
dist.all_reduce(t)
assert t.item() == 3.0, t
print(f"PROC{{pid}} OK", flush=True)
distributed.shutdown()
"""


def _env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("MASTER_ADDR", None)
    env.pop("MASTER_PORT", None)
    return env


def test_free_ports_lie_below_the_ephemeral_range():
    low = _ephemeral_low()
    ports = free_ports(3)
    assert len(set(ports)) == 3
    for p in ports:
        if low > 11_000:
            assert 10_000 <= p < low, (p, low)
        with socket.socket() as s:
            s.bind(("localhost", p))  # free now
    assert free_port(exclude=ports) not in ports


def test_a_port_taken_by_a_connection_fails_the_pair_then_the_retry_runs(
        tmp_path):
    worker = tmp_path / "pair.py"
    worker.write_text(_PAIR.format(repo=_REPO))
    with socket.socket() as srv, socket.socket() as cli:
        srv.bind(("localhost", 0))
        srv.listen()
        cli.connect(srv.getsockname())
        held = cli.getsockname()[1]  # an ephemeral port, as another job's

        def argv(ports, pid):
            return [sys.executable, str(worker), str(ports[0]), str(pid)]

        t0 = time.monotonic()
        failed, tries = run_procs(argv, 2, timeout=120, env=_env(),
                                  cwd=str(tmp_path), ports=[held],
                                  attempts=1)
        took = time.monotonic() - t0
        assert tries == 1 and failed is not None
        assert failed[0][0] != 0 and bind_failed(failed[0][1]), failed[0]
        assert took < 50, f"the failed pair was stopped only after {took}s"
        results, tries = run_procs(argv, 2, timeout=120, env=_env(),
                                   cwd=str(tmp_path), ports=[held])
    assert tries == 2
    for pid, (rc, out) in enumerate(results):
        assert rc == 0 and f"PROC{pid} OK" in out, out[-2000:]
