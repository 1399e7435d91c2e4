"""The device trace of a window, read from ``torch.profiler``'s events.

:class:`Trace` holds what the per-layer readers read: every kernel and
copy the card ran inside the traced window, as intervals on the
profiler's clock, and, in a trace that records the host too, the host's
operators, by which the idle gaps are named.  The window's own trace
records the card alone, since recording the host's operators slows the
host, which paces this step; a short trace with the host after the
window names the gaps.  The profiler is driven from here, not through
the program, so that no change to the program moves the yardstick.
"""

from __future__ import annotations

import json
import re
from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

_BASE = re.compile(r"([A-Za-z_]\w*)\s*[<(]")


def base_name(kernel: str) -> str:
    """The function name of a demangled kernel name:
    ``void obgc::(anonymous namespace)::lanes_kernel<double, ...>(...)``
    -> ``lanes_kernel``."""
    m = _BASE.search(kernel[5:] if kernel.startswith("void ") else kernel)
    return m.group(1) if m else kernel


@dataclass
class Kernel:
    name: str
    start_ns: int
    end_ns: int
    threads: Optional[int]      # grid size times block size, where known


@dataclass
class Trace:
    """The card's activity between ``start_ns`` and ``end_ns``; the
    window lasts ``wall_s`` by the host's clock where that is given (it
    then holds these bounds), else from one bound to the other."""

    start_ns: int
    end_ns: int
    kernels: List[Kernel] = field(default_factory=list)
    copies: List[Tuple[str, int, int]] = field(default_factory=list)
    host_ops: List[Tuple[str, int, int]] = field(default_factory=list)
    wall_s: Optional[float] = None

    @property
    def window_s(self) -> float:
        if self.wall_s is not None:
            return self.wall_s
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self):
        """The union of the kernel and copy intervals, clipped to the
        window, as sorted disjoint (start, end) pairs."""
        spans = sorted([(k.start_ns, k.end_ns) for k in self.kernels]
                       + [(s, e) for _, s, e in self.copies])
        out = []
        for s, e in spans:
            s, e = max(s, self.start_ns), min(e, self.end_ns)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_gaps(self):
        """The gaps in the union, window edges included, as (start, end)."""
        gaps, t = [], self.start_ns
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end_ns > t:
            gaps.append((t, self.end_ns))
        return gaps

    def device_ops(self, top: int = 10):
        """The kernels and copies that took most time, by name, as
        [name, seconds]."""
        by_op = defaultdict(int)
        for k in self.kernels:
            by_op[k.name] += k.end_ns - k.start_ns
        for name, s, e in self.copies:
            by_op[name] += e - s
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        return [[n, v / 1e9] for n, v in ops]

    def idle_by_host(self, top: int = 10):
        """The card's idle time summed by what the host was doing halfway
        through each gap: the innermost host operator running then, CUDA
        runtime calls left out, or ``"python outside operators"``, as
        [name, seconds]."""
        by_host = defaultdict(int)
        ops_ = sorted((s, e, n) for n, s, e in self.host_ops
                      if not n.startswith("cuda"))
        starts = [s for s, _, _ in ops_]
        for gs, ge in self.idle_gaps():
            by_host[_innermost(ops_, starts, (gs + ge) // 2)] += ge - gs
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return [[n, v / 1e9] for n, v in gaps]


def breakdown(window: Trace, host: Trace, top: int = 10):
    """``device_ops`` from the window's trace, ``idle_gaps`` from the
    trace with the host's operators."""
    return {"device_ops": window.device_ops(top),
            "idle_gaps": host.idle_by_host(top)}


def _innermost(ops, starts, t):
    """The name of the latest-starting host operator that contains ``t``
    (``ops`` sorted by start), or ``"python outside operators"`` where
    none does."""
    i = bisect_right(starts, t) - 1
    # host operators nest, so the latest start that still covers t is
    # the innermost; few are open at once, so the walk back is short
    for j in range(i, max(i - 4096, -1), -1):
        s, e, name = ops[j]
        if s <= t < e:
            return name
    return "python outside operators"


WINDOW = "portbench.window"


class Recorder:
    """``torch.profiler`` over the card alone, or with ``host`` over the
    host's operators too.  ``start()``, the traced steps (with ``host``,
    inside ``record_function(WINDOW)``), ``stop()``, and ``read()`` ->
    :class:`Trace` of them.  With ``host`` its bounds are the
    annotation's; without, they are the first and the last activity on
    the card, and ``read(wall_s)`` takes the window's length by the
    host's clock (the run synchronises before the start and at the
    end, so every activity recorded is the traced steps')."""

    def __init__(self, host: bool = False):
        from torch.profiler import ProfilerActivity, profile
        self.host = host
        self._prof = profile(activities=[ProfilerActivity.CUDA]
                             + ([ProfilerActivity.CPU] if host else []))

    def start(self):
        self._prof.start()

    def stop(self):
        self._prof.stop()

    def read(self, wall_s: Optional[float] = None) -> Trace:
        cuda = torch.autograd.DeviceType.CUDA
        events = self._prof.profiler.kineto_results.events()
        device = [ev for ev in events if ev.device_type() == cuda
                  and not ev.is_user_annotation()]
        if self.host:
            bounds = [(ev.start_ns(), ev.start_ns() + ev.duration_ns())
                      for ev in events if ev.name() == WINDOW
                      and ev.device_type() != cuda]
            if len(bounds) != 1:
                raise RuntimeError(f"the trace holds {len(bounds)} windows")
            start_ns, end_ns = bounds[0]
        else:
            if not device:
                raise RuntimeError("the trace holds no activity on the card")
            start_ns = min(ev.start_ns() for ev in device)
            end_ns = max(ev.start_ns() + ev.duration_ns() for ev in device)
        trace = Trace(start_ns, end_ns, wall_s=wall_s)
        for ev in device:
            s = ev.start_ns()
            e = s + ev.duration_ns()
            if e < start_ns or s > end_ns:
                continue
            name = ev.name()
            if name.startswith(("Memcpy", "Memset")):
                trace.copies.append((name, s, e))
            else:
                trace.kernels.append(
                    Kernel(name, s, e, _threads(ev.metadata_json())))
        if self.host:
            trace.host_ops = [
                (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
                for ev in events if ev.device_type() != cuda
                and ev.name() != WINDOW
                and ev.start_ns() + ev.duration_ns() >= start_ns
                and ev.start_ns() <= end_ns]
        return trace


def _threads(meta: str) -> Optional[int]:
    """grid x block threads from a kernel event's metadata, where the
    profiler gives them."""
    try:
        m = json.loads(meta if meta.lstrip().startswith("{")
                       else "{" + meta + "}")
        g, b = m["grid"], m["block"]
        return (int(g[0]) * int(g[1]) * int(g[2])
                * int(b[0]) * int(b[1]) * int(b[2]))
    except (ValueError, KeyError, TypeError, IndexError, AttributeError):
        return None
