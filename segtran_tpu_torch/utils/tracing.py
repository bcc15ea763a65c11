"""Host spans at the program's stage boundaries, kept in memory.

A span is one stage of one item (a serving batch, a train step, a
volume): its name, its start and end on ``time.time_ns()`` (the clock
``torch.profiler`` gives its device timestamps on, so spans and kernels
share one timeline), the span open around it on the same thread (its
parent), the item and the thread. ``span(name, item)`` is a context
manager; ``record(name, t0_ns)`` records a stage whose start was
stamped earlier and returns its end, the next stage's start::

    t = time.time_ns()
    load()
    t = tracing.record("pipeline.load", t, item=n)
    pin()
    tracing.record("pipeline.pin", t, item=n)

A span given no item takes its parent's. Spans only stamp the host's
clock: no synchronisation, no CUDA events, no profiler annotation, so a
span ends when the host has enqueued its stage's device work, and a
stage that waits for the device (a copy to the host) holds the wait.
Spans sit at stage boundaries only, never per layer or per tensor; one
costs a few microseconds of host time.

Counters sit beside them: ``count(name, n)`` adds ``n`` to a running
total (the slices a forward folded into its batch, the all-reduces of a
data-parallel step and their bytes), ``counters()`` reads a copy of
every total; a reader takes the difference of two copies over the items
between them.

Recording is on unless ``SEGTRAN_TRACE=0`` is in the environment at
import, which makes ``span``, ``record`` and ``count`` record nothing
(``ENABLED``). Every thread records into one ``Recorder``: the newest
``CAPACITY`` spans in a ring, and per name a whole-run histogram of
durations in ``BUCKETS_PER_OCTAVE`` log-spaced buckets, whose memory
does not grow with the run. Readers: ``spans`` (the ring),
``histogram``, ``snapshot`` and ``summary``; ``cli/serve.py``'s
``/statz`` and the train3d and test3d logs read the histograms.
"""
from __future__ import annotations

import collections
import math
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

# a 50-s serving window at 180 requests/s and its drain (about 15k
# requests, two spans each, and 2k batches of eight spans) fits
CAPACITY = 65536
# buckets 2**(1/16) (4.4%) apart: a percentile, read at its bucket's
# geometric middle, lies within 2.2% of the exact one
BUCKETS_PER_OCTAVE = 16

ENABLED = os.environ.get("SEGTRAN_TRACE", "1") != "0"


class Span(NamedTuple):
    name: str
    t0: int                   # time.time_ns()
    t1: int
    parent: Optional[str]     # the span open around it on its thread
    item: Optional[int]
    thread: str


def bucket(d_ns: int) -> int:
    """The histogram bucket of a duration."""
    return int(math.log2(d_ns) * BUCKETS_PER_OCTAVE) if d_ns > 1 else 0


class Histogram:
    """Durations by log-spaced bucket: count, sum and bucketed
    percentiles."""

    __slots__ = ("count", "sum_ns", "buckets")

    def __init__(self):
        self.count = 0
        self.sum_ns = 0
        self.buckets: Dict[int, int] = {}

    def add(self, d_ns: int) -> None:
        self.count += 1
        self.sum_ns += d_ns
        b = bucket(d_ns)
        self.buckets[b] = self.buckets.get(b, 0) + 1

    def copy(self) -> "Histogram":
        h = Histogram()
        h.count, h.sum_ns, h.buckets = self.count, self.sum_ns, dict(
            self.buckets)
        return h

    def since(self, earlier: Optional["Histogram"]) -> "Histogram":
        """The durations added after ``earlier``, a copy of this one."""
        h = self.copy()
        if earlier is not None:
            h.count -= earlier.count
            h.sum_ns -= earlier.sum_ns
            for b, n in earlier.buckets.items():
                h.buckets[b] -= n
        return h

    def mean_ms(self) -> Optional[float]:
        return self.sum_ns / self.count / 1e6 if self.count else None

    def percentile_ms(self, q: float) -> Optional[float]:
        """The nearest-rank ``q``-th percentile's bucket, as its geometric
        middle (None when empty)."""
        if self.count <= 0:
            return None
        rank = max(1, math.ceil(q / 100 * self.count))
        seen = 0
        for b in sorted(self.buckets):
            seen += self.buckets[b]
            if seen >= rank:
                return 2 ** ((b + 0.5) / BUCKETS_PER_OCTAVE) / 1e6
        return None


class Recorder:
    """Spans from any thread: the newest ``capacity`` in a ring, and a
    whole-run histogram per name."""

    def __init__(self, capacity: int = CAPACITY):
        self._ring: "collections.deque" = collections.deque(maxlen=capacity)
        self._hist: Dict[str, Histogram] = {}
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        local = self._local
        try:
            return local.stack
        except AttributeError:
            local.stack = []
            local.thread = threading.current_thread().name
            return local.stack

    def record(self, name: str, t0_ns: int, t1_ns: Optional[int] = None,
               item: Optional[int] = None) -> int:
        """Record the stage ``name`` from ``t0_ns`` to ``t1_ns`` (now where
        None); returns its end."""
        if t1_ns is None:
            t1_ns = time.time_ns()
        stack = self._stack()
        parent = stack[-1] if stack else None
        if item is None and parent is not None:
            item = parent.item
        self._add(Span(name, t0_ns, t1_ns, parent.name if parent else None,
                       item, self._local.thread))
        return t1_ns

    def span(self, name: str, item: Optional[int] = None) -> "_Open":
        return _Open(self, name, item)

    def _add(self, s: Span) -> None:
        with self._lock:
            self._ring.append(s)
            h = self._hist.get(s.name)
            if h is None:
                h = self._hist[s.name] = Histogram()
            h.add(s.t1 - s.t0)

    def spans(self, name: str, t0_ns: Optional[int] = None,
              t1_ns: Optional[int] = None) -> List[Span]:
        """The ring's spans ``name`` that overlap [t0_ns, t1_ns], oldest
        first."""
        lo = -math.inf if t0_ns is None else t0_ns
        hi = math.inf if t1_ns is None else t1_ns
        with self._lock:
            ring = list(self._ring)
        return [s for s in ring if s.name == name and s.t1 >= lo
                and s.t0 <= hi]

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``."""
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def counters(self) -> Dict[str, int]:
        """A copy of every counter's total."""
        with self._lock:
            return dict(self._counts)

    def histogram(self, name: str) -> Histogram:
        """A copy of the whole run's histogram of ``name``."""
        with self._lock:
            h = self._hist.get(name)
            return h.copy() if h is not None else Histogram()

    def snapshot(self) -> Dict[str, Histogram]:
        """Copies of every histogram, for ``Histogram.since`` later."""
        with self._lock:
            return {k: h.copy() for k, h in self._hist.items()}

    def means_ms(self, names, since: Optional[Dict[str, Histogram]] = None
                 ) -> Dict[str, float]:
        """{name: mean ms} of the spans ``names`` recorded since the
        snapshot ``since``, for the names that have any."""
        since = since or {}
        out = {}
        for n in names:
            m = self.histogram(n).since(since.get(n)).mean_ms()
            if m is not None:
                out[n] = m
        return out

    def summary(self) -> Dict[str, dict]:
        """{name: count, mean and percentiles in ms} over the whole run."""
        out = {}
        for name, h in self.snapshot().items():
            out[name] = {"count": h.count, "mean_ms": h.mean_ms(),
                         **{f"p{q}_ms": h.percentile_ms(q)
                            for q in (50, 95, 99)}}
        return out


class _Open:
    __slots__ = ("rec", "name", "item", "t0")

    def __init__(self, rec: Recorder, name: str, item: Optional[int]):
        self.rec, self.name, self.item = rec, name, item

    def __enter__(self) -> "_Open":
        stack = self.rec._stack()
        if self.item is None and stack:
            self.item = stack[-1].item
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.time_ns()
        stack = self.rec._stack()
        stack.pop()
        parent = stack[-1].name if stack else None
        self.rec._add(Span(self.name, self.t0, t1, parent, self.item,
                           self.rec._local.thread))


class _Off:
    """The shared span of ``ENABLED = False``."""

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()
RECORDER = Recorder()


def span(name: str, item: Optional[int] = None):
    """A context manager recording the stage ``name`` of ``item``."""
    return RECORDER.span(name, item) if ENABLED else _OFF


def record(name: str, t0_ns: int, t1_ns: Optional[int] = None,
           item: Optional[int] = None) -> int:
    """Record a stage whose start was stamped earlier; returns its end
    (0 with recording off)."""
    return RECORDER.record(name, t0_ns, t1_ns, item) if ENABLED else 0


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (nothing with recording off)."""
    if ENABLED:
        RECORDER.count(name, n)


spans = RECORDER.spans
counters = RECORDER.counters
histogram = RECORDER.histogram
snapshot = RECORDER.snapshot
means_ms = RECORDER.means_ms
summary = RECORDER.summary
