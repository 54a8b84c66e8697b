"""Launching the port's multi-process gloo tests.

One helper for every ``tests/test_torch_*.py`` file that starts several
processes on a localhost gloo group through
``parallel/distributed.initialize``:

- :func:`free_port` picks the rendezvous port below the kernel's
  ephemeral range (``/proc/sys/net/ipv4/ip_local_port_range``). A port
  taken with ``bind(("localhost", 0))`` and closed again comes from that
  range, and until process 0 listens on it (seconds later: the children
  import torch first) any other socket on the host the kernel picks a
  port for (a concurrent test's gloo listeners, which bind to port 0,
  or an outgoing connection) may be given it, after which the listen
  fails with ``EADDRINUSE`` even with ``SO_REUSEADDR``. The kernel
  never picks a port below the range, so only an explicit bind could
  take it.
- :func:`run_procs` starts the processes and waits for all of them; when
  one exits because the rendezvous could not bind its port, it stops the
  others (whose join would otherwise wait out its timeout) and runs the
  whole group once more on fresh ports.
"""

from __future__ import annotations

import random
import socket
import subprocess
import threading
import time

# what torch's TCPStore says when the rendezvous port is taken
BIND_FAILED = ("EADDRINUSE", "address already in use")
_FLOOR = 10_000  # never below the registered services' usual ports


def _ephemeral_low() -> int:
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0


def _bindable(port: int) -> bool:
    with socket.socket() as s:
        try:
            s.bind(("localhost", port))
        except OSError:
            return False
    return True


def free_port(exclude=()) -> int:
    """A port no process holds now, below the ephemeral range where the
    range leaves room (else the kernel's own pick), and not in
    ``exclude``."""
    low = _ephemeral_low()
    rng = random.SystemRandom()
    if low > _FLOOR + 1_000:
        for _ in range(256):
            port = rng.randrange(_FLOOR, low)
            if port not in exclude and _bindable(port):
                return port
    while True:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        if port not in exclude:
            return port


def free_ports(n: int) -> list:
    """``n`` distinct ports, each as :func:`free_port`."""
    out: list = []
    for _ in range(n):
        out.append(free_port(exclude=out))
    return out


def bind_failed(out: str) -> bool:
    """Whether a process's output says its rendezvous port was taken."""
    return any(s in out for s in BIND_FAILED)


def run_procs(argv, n: int, *, timeout: float, env=None, cwd=None,
              n_ports: int = 1, attempts: int = 2, ports=None):
    """Run ``argv(ports, rank)`` for ranks ``0..n-1`` (``ports`` a list of
    ``n_ports`` fresh ports, or the given ``ports`` on the first attempt)
    and wait for every process, at most ``timeout`` seconds an attempt.

    Returns ``(results, tries)``: ``results`` a list of ``(returncode,
    output)`` per rank, or None when the group hung (every process
    killed), and ``tries`` the attempts made. An attempt in which a
    process exited on a taken rendezvous port (:func:`bind_failed`) is
    stopped at once and, while ``attempts`` allow, run again on fresh
    ports."""
    for attempt in range(1, attempts + 1):
        use = list(ports) if ports is not None and attempt == 1 else \
            free_ports(n_ports)
        procs = [subprocess.Popen(
            argv(use, rank), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env, cwd=cwd)
            for rank in range(n)]
        outs = _wait(procs, timeout)
        if outs is None:
            return None, attempt
        results = [(p.returncode, out) for p, out in zip(procs, outs)]
        retry = any(rc != 0 and bind_failed(out) for rc, out in results)
        if not retry or attempt == attempts:
            return results, attempt
    raise AssertionError("unreachable")


def _wait(procs, timeout: float):
    """Every process's output, or None after killing them all at the
    deadline. A process that exits on a taken port stops the rest."""
    outs = [""] * len(procs)

    def drain(i, p):
        outs[i] = p.stdout.read()

    readers = [threading.Thread(target=drain, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in readers:
        t.start()
    deadline = time.monotonic() + timeout
    stopped = False
    while any(p.poll() is None for p in procs):
        if time.monotonic() > deadline:
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()
            return None
        if not stopped:
            for i, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    readers[i].join(timeout=5)
                    if bind_failed(outs[i]):
                        stopped = True
                        for q in procs:
                            if q.poll() is None:
                                q.kill()
        time.sleep(0.05)
    for t in readers:
        t.join(timeout=30)
    for p in procs:
        p.stdout.close()
    return outs
