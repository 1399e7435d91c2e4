"""Tracing and timing helpers.

Counterpart of ``ocean_bgc_tpu/utils/profiling.py`` (the reference has
none; SURVEY.md §5 notes only commented-out printf relics).

* :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace
  (``trace.json``, for Perfetto or ``chrome://tracing``) of the host and,
  where a card is present, the device activity.
* :func:`step_timer`: timing of a callable, by CUDA events when its
  arguments hold CUDA tensors and by the host clock otherwise.

The JAX module's ``cost_summary`` (XLA cost analysis) has no counterpart:
``chip_smoke.py`` computes each kernel's bound from the bytes and
operations of its inputs instead.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace("/tmp/prof") as prof: fn(...)`` writes
    ``/tmp/prof/trace.json``; ``prof`` is the ``torch.profiler.profile``
    (``prof.key_averages()`` sums time by operator and kernel).  The
    device is synchronised before the trace closes, so queued kernels
    are in it."""
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
                torch.cuda.synchronize()
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
            torch.cuda.synchronize(dev)

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
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return {"best": min(times), "mean": sum(times) / len(times),
            "compile": compile_s}
