"""The traffic: a request schedule made from the seed, and the open and
closed loops that drive it over HTTP.

Every seed gets the same work in another order: the (source, query)
pairs come in whole rounds of the mix (each pair as often as its
weight), each round shuffled; an open loop's gaps are the same set of
exponential quantiles (a Poisson process of the mix's rate, its
arrivals spread evenly over the quantiles), shuffled.

An open loop times a request from when it was due, not from when it
was sent, so a stall that delays later sends shows in their latency;
how late the generator sent is kept apart (`lateness`). A request that
fails (no answer, or another status than 200) has an infinite latency.
A closed loop has `connections` clients, each sending its next request
when its previous one is answered.
"""

from __future__ import annotations

import asyncio
import dataclasses
import math
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .compare import body_hash

# how long past the window's close a request is still waited for
LATE_S = 60.0


@dataclasses.dataclass
class Record:
    src: str
    query: str
    due: float  # perf_counter seconds: when it was due (closed: sent)
    sent: float = 0.0
    done: float = math.inf
    status: int = 0  # 0: no answer
    body_hash: Optional[str] = None
    timing: Dict[str, float] = dataclasses.field(default_factory=dict)
    cold: bool = False

    @property
    def latency_s(self) -> float:
        """From due to answered; infinite for a failed request."""
        return self.done - self.due if self.status == 200 else math.inf


def pairs(traffic: dict, sources: Sequence[str], seed: int) -> Iterator[Tuple[str, str]]:
    """Endless (source, query) pairs: whole shuffled rounds of every
    source under every query, each query `weight` times."""
    rnd = [(s, q["query"]) for q in traffic["queries"]
           for _ in range(int(q.get("weight", 1))) for s in sources]
    rng = np.random.default_rng([seed, 1])
    while True:
        for i in rng.permutation(len(rnd)):
            yield rnd[i]


def poisson_gaps(rate: float, seconds: float, seed: int) -> np.ndarray:
    """round(rate * seconds) gaps whose values are the exponential
    distribution's quantiles at (i + 0.5) / n, in an order drawn from
    the seed, scaled to sum to n / rate."""
    n = max(int(round(rate * seconds)), 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps *= (n / rate) / gaps.sum()
    return np.random.default_rng([seed, 2]).permutation(gaps)


def parse_server_timing(header: str) -> Dict[str, float]:
    out = {}
    for part in header.split(","):
        name, _, dur = part.strip().partition(";dur=")
        if dur:
            try:
                out[name] = float(dur)
            except ValueError:
                pass
    return out


class Client:
    """One HTTP client session against the server at `base`, keeping
    every distinct body it reads (by hash) for the check."""

    def __init__(self, session, base: str, prefix: str, accept: str):
        self.session = session
        self.base = base
        self.prefix = prefix
        self.headers = {"Accept": accept} if accept else {}
        self.bodies: Dict[str, bytes] = {}

    async def fetch(self, rec: Record) -> Record:
        import aiohttp

        rec.sent = time.perf_counter()
        try:
            async with self.session.get(
                    f"{self.base}/{self.prefix}/{rec.src}?{rec.query}",
                    headers=self.headers,
                    timeout=aiohttp.ClientTimeout(total=LATE_S + 30)) as r:
                body = await r.read()
                rec.done = time.perf_counter()
                rec.status = r.status
                rec.timing = parse_server_timing(
                    r.headers.get("Server-Timing", ""))
                rec.cold = r.headers.get("X-Cache-Warmth") == "cold"
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
            rec.done, rec.status = time.perf_counter(), 0
            return rec
        if rec.status == 200 and body:
            h = body_hash(body)
            self.bodies.setdefault(h, body)
            rec.body_hash = h
        return rec


async def _await_all(tasks: List[asyncio.Task], deadline: float) -> None:
    """Wait for `tasks` until `deadline` (perf_counter); cancel the rest,
    which then count as never answered."""
    left = deadline - time.perf_counter()
    if tasks:
        _, pending = await asyncio.wait(tasks, timeout=max(left, 0.0))
        for t in pending:
            t.cancel()
        await asyncio.gather(*pending, return_exceptions=True)


async def open_loop(client: Client, schedule: Iterator[Tuple[str, str]],
                    gaps: np.ndarray, t0: float) -> List[Record]:
    """Send one request at each due time t0 + cumsum(gaps) (the first
    at t0); wait for every answer up to LATE_S past the last due time."""
    due = t0 + np.concatenate(([0.0], np.cumsum(gaps)[:-1]))
    records, tasks = [], []
    for d in due:
        now = time.perf_counter()
        if d > now:
            await asyncio.sleep(d - now)
        src, query = next(schedule)
        rec = Record(src, query, float(d))
        records.append(rec)
        tasks.append(asyncio.ensure_future(client.fetch(rec)))
    await _await_all(tasks, float(due[-1]) + LATE_S)
    return records


async def closed_loop(client: Client, schedule: Iterator[Tuple[str, str]],
                      connections: int, t0: float, t_end: float) -> List[Record]:
    """`connections` clients from t0, each sending its next request as
    soon as its last is answered, until t_end; the requests in flight
    at t_end are waited for up to LATE_S."""
    records: List[Record] = []

    async def one_client():
        now = time.perf_counter()
        if t0 > now:
            await asyncio.sleep(t0 - now)
        while time.perf_counter() < t_end:
            src, query = next(schedule)
            rec = Record(src, query, time.perf_counter())
            records.append(rec)
            await client.fetch(rec)

    tasks = [asyncio.ensure_future(one_client()) for _ in range(connections)]
    await _await_all(tasks, t_end + LATE_S)
    for rec in records:
        if rec.sent == 0.0:
            rec.sent = rec.due
    return records


async def drive(client: Client, traffic: dict, sources: Sequence[str],
                seed: int, seconds: float, t0: float) -> List[Record]:
    """The traffic mix for `seconds` from t0: its loop, its rate or its
    connections."""
    schedule = pairs(traffic, sources, seed)
    if traffic["loop"] == "open":
        if traffic.get("arrival", "poisson") != "poisson":
            raise ValueError(f"unknown arrival law {traffic['arrival']!r}")
        gaps = poisson_gaps(float(traffic["rate"]), seconds, seed)
        return await open_loop(client, schedule, gaps, t0)
    if traffic["loop"] == "closed":
        return await closed_loop(client, schedule, int(traffic["connections"]),
                                 t0, t0 + seconds)
    raise ValueError(f"unknown loop {traffic['loop']!r}")
