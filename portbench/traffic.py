"""The one traffic generator: a mix file's parameters and a seed in, a
request stream out. Every mix of ``portbench/mixes/`` is read here; a new
mix is a new data file, never new code.

A served mix (``"driver": "served"``) gives:

* ``arrivals`` — ``{"kind": "poisson", "rate_per_s": r}``: open-loop
  arrivals, exponential gaps at rate ``r`` over the window; or
  ``{"kind": "closed_loop", "clients": c, "max_requests": m}``: ``c``
  clients, each sending its next request when its last one's scores are
  in, at most ``m`` requests in a window;
* ``pool`` — ``{"kind": "log_uniform", "lo": a, "hi": b}``: candidates per
  request, integers log-uniform on ``[a, b]``;
* ``users`` — ``{"kind": "fresh"}``: a new user id per request, so stage 1
  runs for each;
* ``user_feature_sets`` — user feature rows are cycled from this many
  sets, drawn once in set-up;
* ``candidate_rows`` — candidate rows drawn once in set-up; a request
  takes a contiguous slice at a seed-drawn offset, so making traffic costs
  the window nothing;
* ``check_sample`` — requests whose scores are held against the
  reference after the window, drawn from the seed (open loop: from the
  stream, the longest pool always among them; closed loop: a seeded
  reservoir over the requests sent, with the longest one finished).

A bulk mix (``"driver": "bulk"``) gives ``rows`` (candidates per call,
one user each), ``feed_ring`` (distinct pinned batches the calls cycle
through) and ``check_sample`` (calls held against the reference, a
seeded reservoir over the calls made).

The same seed gives the same stream: arrivals, pool sizes, user ids,
feature sets and slice offsets; another seed gives the same gaps and
sizes in another order.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

MIXES = Path(__file__).resolve().parent / "mixes"

# user ids of the stream start here; set-up's warm-up users lie below it
FIRST_USER_ID = 1 << 40


def load_mix(name: str) -> dict:
    return json.loads((MIXES / f"{name}.json").read_text())


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator per purpose (``stream``) of one
    seed; any non-negative integer seed, however large."""
    return np.random.default_rng([int(seed), stream])


def log_uniform_ints(rng: np.random.Generator, lo: int, hi: int, n: int
                     ) -> np.ndarray:
    """``n`` integers log-uniform on ``[lo, hi]``."""
    x = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), n))
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


def poisson_arrivals(rng: np.random.Generator, rate: float, seconds: float
                     ) -> np.ndarray:
    """Due offsets (seconds from the window's start) of a Poisson process
    at ``rate`` over ``[0, seconds)``."""
    n = int(rate * seconds * 1.5 + 64)
    t = np.cumsum(rng.exponential(1.0 / rate, n))
    while t[-1] < seconds:
        t = np.concatenate([t, t[-1] + np.cumsum(
            rng.exponential(1.0 / rate, n))])
    return t[t < seconds]


@dataclasses.dataclass
class Stream:
    """One window's requests, in due order."""
    due: np.ndarray          # (n,) seconds from the window's start
    pool: np.ndarray         # (n,) candidates per request
    offset: np.ndarray       # (n,) first candidate row of the slice
    user_id: np.ndarray      # (n,) the engine's user key
    user_set: np.ndarray     # (n,) index of the user's feature set
    check: np.ndarray        # indices of requests held to the reference

    def __len__(self) -> int:
        return len(self.due)


def served_stream(mix: dict, seed: int, seconds: float) -> Stream:
    """The request stream of a served mix for one window. Every seed
    gets the same multiset of arrival gaps and pool sizes (drawn from one
    fixed seed) in its own order, so seeds change
    which requests come when, never the work; offsets, users and the
    checked sample follow the seed."""
    base = rng_for(0, 0)
    rng = rng_for(seed, 1)
    arr = mix["arrivals"]
    if arr["kind"] == "poisson":
        due = poisson_arrivals(base, float(arr["rate_per_s"]), seconds)
        n = len(due)
        gaps = np.diff(due, prepend=0.0)
        due = np.cumsum(gaps[rng.permutation(n)])
    elif arr["kind"] == "closed_loop":
        n = int(arr["max_requests"])
        due = np.zeros(n)
    else:
        raise ValueError(f"unknown arrivals kind {arr['kind']!r}")
    pool = mix["pool"]
    if pool["kind"] != "log_uniform":
        raise ValueError(f"unknown pool kind {pool['kind']!r}")
    sizes = log_uniform_ints(base, int(pool["lo"]), int(pool["hi"]), n)
    sizes = sizes[rng.permutation(n)]
    rows = int(mix["candidate_rows"])
    if sizes.max(initial=0) > rows:
        raise ValueError("a pool is larger than the candidate rows drawn")
    offset = np.floor(rng.random(n) * (rows - sizes + 1)).astype(np.int64)
    if mix["users"]["kind"] != "fresh":
        raise ValueError(f"unknown users kind {mix['users']['kind']!r}")
    uid = FIRST_USER_ID + np.arange(n, dtype=np.int64)
    uset = np.arange(n, dtype=np.int64) % int(mix["user_feature_sets"])
    k = min(int(mix["check_sample"]), n)
    check = rng.choice(n, size=k, replace=False) if k else np.zeros(0, int)
    if n:
        check = np.union1d(check, [int(np.argmax(sizes))])
    return Stream(due=due, pool=sizes, offset=offset, user_id=uid,
                  user_set=uset, check=np.asarray(check, dtype=np.int64))


class Reservoir:
    """A seeded uniform sample of ``k`` items from a stream of unknown
    length (Algorithm R): the bulk driver's calls, or a closed loop's
    requests, held to the reference."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = rng_for(seed, 2)
        self.items: list = []
        self.seen = 0

    def slot(self) -> int | None:
        """The slot the next item takes, or None if it is not kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.k else None
