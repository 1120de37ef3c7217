"""Open-loop Poisson load generation for the retrieval server.

Open-loop means arrival times are drawn up front (exponential
inter-arrivals at ``rate`` req/s, cumsum'd) and requests are submitted
at those instants REGARDLESS of completions — the standard way to
measure tail latency without coordinated omission (a closed loop slows
its own arrivals whenever the server stalls, hiding exactly the
queueing the p99 is supposed to expose).

Request histories are variable-length uniform draws over the *valid*
catalogue ids — reserved rows (pad 0, and [MASK] for sequential heads)
are excluded.  Both generators draw from ``np.random.default_rng(seed)``
in the JAX package's order, so the same seed gives the same arrays.

``run_open_loop`` drives a server object against either the real clock
(CLI, ``chip_smoke.py``) or a virtual clock (tests): with a
``VirtualClock`` time jumps instantly to the next event (arrival or
queue deadline), so a deterministic run that "takes" seconds of
simulated traffic finishes in milliseconds.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np


def poisson_arrivals(rate: float, n: int, seed: int = 0) -> np.ndarray:
    """[n] arrival times (seconds from t=0) of a Poisson process at
    ``rate`` req/s."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0: {rate}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=int(n)))


def request_stream(n: int, *, n_items: int, max_len: int,
                   min_len: int = 1, reserved: Sequence[int] = (0,),
                   seed: int = 0) -> List[np.ndarray]:
    """n variable-length histories of valid item ids (1-based rows,
    ``reserved`` excluded — never ask the server about the pad row)."""
    rng = np.random.default_rng(seed)
    valid = np.setdiff1d(np.arange(n_items + 1), np.asarray(reserved))
    if valid.size == 0:
        raise ValueError("no valid ids left after reserving")
    lens = rng.integers(min_len, max_len + 1, size=int(n))
    return [valid[rng.integers(0, valid.size, size=l)].astype(np.int32)
            for l in lens]


class VirtualClock:
    """Manually-advanced monotonic clock for deterministic tests."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance_to(self, t: float) -> None:
        self.t = max(self.t, float(t))


def run_open_loop(server, hists: Sequence[np.ndarray],
                  arrivals: np.ndarray, *,
                  clock: Optional[VirtualClock] = None
                  ) -> List[Tuple[int, float]]:
    """Submit ``hists[i]`` at ``arrivals[i]`` and pump the server.

    With a ``VirtualClock`` (which must be the server's clock too) the
    loop advances simulated time to each next event; otherwise it
    sleeps on the real clock.  Returns [(rid, t_submit)] in submission
    order; results/latencies accumulate in the server itself."""
    if len(hists) != len(arrivals):
        raise ValueError("hists and arrivals must align")
    virtual = clock is not None
    t0 = 0.0 if virtual else time.monotonic()
    now = (clock if virtual else
           (lambda: time.monotonic() - t0))
    submitted: List[Tuple[int, float]] = []
    i = 0
    while i < len(hists) or server.in_flight():
        if i < len(hists):
            t_arr = float(arrivals[i])
            if virtual:
                # jump to whichever event is next: this arrival or a
                # pending deadline flush
                dl = server.next_deadline()
                if dl is not None and dl < t_arr:
                    clock.advance_to(dl)
                    server.pump()
                    continue
                clock.advance_to(t_arr)
            else:
                while now() < t_arr:
                    server.pump()
                    time.sleep(max(0.0, min(1e-4, t_arr - now())))
            rid = server.submit(hists[i])
            submitted.append((rid, t_arr))
            i += 1
            server.pump()
        else:
            if virtual:
                dl = server.next_deadline()
                if dl is not None:
                    clock.advance_to(dl)
            server.pump(force=i >= len(hists) and virtual)
            if not virtual and server.in_flight():
                time.sleep(1e-4)
    return submitted
