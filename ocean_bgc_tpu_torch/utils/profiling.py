"""Tracing, counting and timing helpers: the port's one facility for
spans and counters.

Counterpart of ``ocean_bgc_tpu/utils/profiling.py`` (the reference has
none; SURVEY.md §5 notes only commented-out printf relics).

* :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace
  (``trace.json``, for Perfetto or ``chrome://tracing``) of the host and,
  where a card is present, the device activity.
* :func:`span`: a named stretch of the host's work inside the port's
  step (``step`` and its layers, ``precompute_env``), recorded only while
  ``torch.profiler`` is recording: then it enters
  ``torch.profiler.record_function`` (so the trace shows it) and appends
  a :class:`SpanRecord` on the wall clock, the clock the profiler stamps
  its host and device events with, to a bounded buffer (:func:`spans`).
  Otherwise it is one shared no-op context.  It never synchronises,
  launches or copies.
* :func:`count`, :func:`counters`: the process's counters, always on:
  every kernel launch by kernel (``k1.*``, ``k2.*``, ``probe``), the
  collectives (``collectives.*``) and ``host_syncs``, one per readback of
  a device tensor or wait for the device (:func:`readback`,
  :func:`synchronize`).
* :func:`step_timer`: timing of a callable, by CUDA events when its
  arguments hold CUDA tensors and by the host clock otherwise.

The JAX module's ``cost_summary`` (XLA cost analysis) has no counterpart:
``chip_smoke.py`` computes each kernel's bound from the bytes and
operations of its inputs instead.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

_COUNTS: collections.Counter = collections.Counter()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] += n


def counters() -> collections.Counter:
    """A copy of every counter; one never counted reads 0."""
    return collections.Counter(_COUNTS)


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def readback(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, counting one in ``host_syncs`` where it lives on a
    card: wrap the tensor that an ``.item()``, ``.tolist()``, ``bool()``,
    ``float()`` or a copy to the host reads."""
    if _on_card(t):
        _COUNTS["host_syncs"] += 1
    return t


def synchronize(device=None) -> None:
    """``torch.cuda.synchronize(device)``, counted in ``host_syncs``."""
    _COUNTS["host_syncs"] += 1
    torch.cuda.synchronize(device)


class SpanRecord(NamedTuple):
    """One closed span: ``index`` in the order spans opened, the wall
    clock's ``start_ns``/``end_ns`` (``time.time_ns``), the ``parent``
    span's index (None for a root), the ``root`` span's index (its own
    for a root: a ``step`` root's index is the step's id) and the
    counters' changes over the span (``counts``, only those that
    changed)."""

    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    root: int
    counts: Dict[str, int]


# the spans kept, the newest last; an older one is dropped past this
SPAN_CAPACITY = 1 << 16
_SPANS: collections.deque = collections.deque(maxlen=SPAN_CAPACITY)
_INDEX = itertools.count()
_OPEN: list = []       # the open spans, the innermost last
_OFF = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


class _Span:
    __slots__ = ("name", "index", "parent", "root", "before", "start_ns",
                 "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        outer = _OPEN[-1] if _OPEN else None
        self.index = next(_INDEX)
        self.parent = outer.index if outer is not None else None
        self.root = outer.root if outer is not None else self.index
        _OPEN.append(self)
        self.before = dict(_COUNTS)
        self.annotation = torch.profiler.record_function(self.name)
        # the record's interval holds the annotation's, which holds the
        # span's launches
        self.start_ns = time.time_ns()
        self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        self.annotation.__exit__(*exc)
        end_ns = time.time_ns()
        _OPEN.pop()
        before = self.before
        changed = {k: v - before.get(k, 0) for k, v in _COUNTS.items()
                   if v != before.get(k, 0)}
        _SPANS.append(SpanRecord(self.index, self.name, self.start_ns,
                                 end_ns, self.parent, self.root, changed))
        return False


def span(name: str):
    """``with span("step.surface"): ...``: recorded (see the module's
    docstring) while ``torch.profiler`` is recording, else the shared
    no-op context, which allocates nothing and reads no clock.  A span
    opened inside another is its child: spans are opened by one thread,
    as the step runs."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name)


def spans() -> List[SpanRecord]:
    """The recorded spans, in the order they closed (a child before its
    parent)."""
    return list(_SPANS)


def reset_spans() -> None:
    """Drop the recorded spans."""
    _SPANS.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace("/tmp/prof") as prof: fn(...)`` writes
    ``/tmp/prof/trace.json``; ``prof`` is the ``torch.profiler.profile``
    (``prof.key_averages()`` sums time by operator and kernel).  The
    device is synchronised before the trace closes, so queued kernels
    are in it.  The port's spans recorded inside are in the trace as
    ``record_function`` ranges, and in :func:`spans`."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:
                synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _cuda_device(tree):
    """The device of the first CUDA tensor in ``tree`` (tensors,
    dataclasses, tuples, lists and dicts of them), or None."""
    if isinstance(tree, torch.Tensor):
        return tree.device if tree.is_cuda else None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for leaf in tree:
            dev = _cuda_device(leaf)
            if dev is not None:
                return dev
    return None


def step_timer(fn: Callable, *args, warmup: int = 1,
               repeats: int = 5) -> Dict[str, float]:
    """Time ``fn(*args)``: the first call (which builds the kernels it
    launches on first use), then ``warmup - 1`` more untimed, then
    ``repeats`` timed calls.  Returns {best, mean, compile} seconds, where
    ``compile`` is the first call's time.

    With CUDA tensors among ``args``, each timed call is bracketed by
    CUDA events on the current stream and waited for, so a time is the
    device's span of the call (its launches included); otherwise the host
    clock times each call."""
    dev = _cuda_device(list(args))

    def sync():
        if dev is not None:
            synchronize(dev)

    t0 = time.perf_counter()
    fn(*args)
    sync()
    compile_s = time.perf_counter() - t0
    for _ in range(max(0, warmup - 1)):
        fn(*args)
    sync()
    times = []
    for _ in range(repeats):
        if dev is None:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        count("host_syncs")
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return {"best": min(times), "mean": sum(times) / len(times),
            "compile": compile_s}
