"""A closed loop (a mix's ``"loop": "closed"``): ``clients`` 1, who sends
the next operation when the last has returned, until the window's seconds
have passed; the last operation ends. Each operation's latency ends with the
card synchronised. The first operation that raises ends the window and
counts as failed. More clients, or load offered at a rate, are loops of
their own."""
from __future__ import annotations

import sys
import time


def run(mix: dict, ops, seconds: float, record, sync, log) -> tuple:
    """(done, failed): ``done`` the (kind, tag, entries, seconds) of every
    operation that returned."""
    if mix.get("clients", 1) != 1:
        raise ValueError("the closed loop drives one client")
    done, failed = [], 0
    start = time.perf_counter()
    for kind, tag, call in ops:
        with record(kind):
            t_op = time.perf_counter()
            try:
                n = call()
            except Exception as exc:  # the run goes on to report it
                log(f"{kind} {tag} failed: {exc!r}", file=sys.stderr)
                failed += 1
                break
            sync()
            done.append((kind, tag, n, time.perf_counter() - t_op))
        if time.perf_counter() - start >= seconds:
            break
    return done, failed
