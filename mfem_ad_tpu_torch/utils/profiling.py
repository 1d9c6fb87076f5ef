"""Tracing and profiling: a per-phase cost table and torch.profiler traces.

PyTorch counterpart of ``mfem_ad_tpu.utils.profiling``, in two layers:

1. A host-side **per-phase cost table**: ``phase("name")`` context
   managers accumulate wall time and call counts into a process-global
   registry; ``cost_table()`` / ``format_cost_table()`` snapshot it.
   Phases nest; the table reports both inclusive ("total") and exclusive
   ("self") time, so a parent phase's own cost shows beside its children.

2. **Device timeline traces** through ``trace(logdir)``, which wraps
   ``torch.profiler.profile`` (CPU and, where there is a card, CUDA
   activities) and writes a Chrome trace into ``logdir``: of the whole
   block, or of its second outer iteration where the code marks them
   with ``step()``.  Every ``phase`` also opens a
   ``torch.profiler.record_function`` span, so host phases appear as
   named spans on the timeline whenever a trace is active.

CUDA launches are asynchronous, so a phase that only launches device
work looks cheap on the host clock.  ``phase(name, sync=tensors)``
synchronises the card on exit when any of the given tensors lie on it,
so the phase charges the device work it launched.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field

import torch


@dataclass
class PhaseStat:
    """Accumulated cost of one named phase."""

    total_s: float = 0.0   # inclusive wall time
    child_s: float = 0.0   # wall time spent in nested phases
    count: int = 0

    @property
    def self_s(self) -> float:
        return max(0.0, self.total_s - self.child_s)


@dataclass
class _Registry:
    stats: dict = field(default_factory=dict)
    lock: threading.Lock = field(default_factory=threading.Lock)
    # per-thread stack of [name, child-time accumulator]
    local: threading.local = field(default_factory=threading.local)


_REG = _Registry()


def reset() -> None:
    """Clear all accumulated phase statistics."""
    with _REG.lock:
        _REG.stats.clear()


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _leaves(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _leaves(o)


def _synchronize(sync) -> None:
    """Wait for the card when any tensor in ``sync`` lies on it."""
    for t in _leaves(sync):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


@contextlib.contextmanager
def phase(name: str, sync=None):
    """Accumulate wall time under ``name``; nestable; annotates traces.

    ``sync``: an optional tensor, or a list, tuple or dict of tensors; on
    exit the card is synchronised when any of them lies on it.
    """
    stack = getattr(_REG.local, "stack", None)
    if stack is None:
        stack = _REG.local.stack = []
    stack.append([name, 0.0])
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
            if sync is not None:
                _synchronize(sync)
    finally:
        dt = time.perf_counter() - t0
        _, child = stack.pop()
        if stack:
            stack[-1][1] += dt
        with _REG.lock:
            st = _REG.stats.setdefault(name, PhaseStat())
            st.total_s += dt
            st.child_s += child
            st.count += 1


def cost_table() -> dict:
    """Snapshot ``{name: PhaseStat}`` of everything accumulated so far."""
    with _REG.lock:
        return {
            k: PhaseStat(v.total_s, v.child_s, v.count)
            for k, v in _REG.stats.items()
        }


def format_cost_table(stats: dict | None = None) -> str:
    """Render the cost table, widest total first."""
    stats = cost_table() if stats is None else stats
    if not stats:
        return "(no phases recorded)"
    rows = sorted(stats.items(), key=lambda kv: -kv[1].total_s)
    w = max(5, max(len(k) for k in stats))
    lines = [
        f"{'phase':<{w}}  {'total[s]':>10}  {'self[s]':>10}  "
        f"{'calls':>7}  {'per-call[s]':>11}"
    ]
    for name, st in rows:
        lines.append(
            f"{name:<{w}}  {st.total_s:>10.3f}  {st.self_s:>10.3f}  "
            f"{st.count:>7d}  {st.total_s / max(1, st.count):>11.4f}"
        )
    return "\n".join(lines)


def print_cost_table() -> None:
    print(format_cost_table(), flush=True)


class _Trace:
    """One ``trace``: a torch.profiler session into ``logdir``, restarted
    at the first ``step()`` and ended at the second."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.steps = 0
        self.prof = None

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()

    def stop(self, export: bool = True):
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        if export:
            os.makedirs(self.logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self.logdir, "trace.json"))


_TRACES: list = []


def step() -> None:
    """Mark the end of one outer iteration (``PGSolver`` marks each PG
    iteration).  An active ``trace`` drops what it recorded before the
    first mark and keeps the iteration between the first and the second:
    a trace of a whole solve holds millions of small launches."""
    for tr in _TRACES:
        tr.steps += 1
        if tr.steps == 1:
            tr.stop(export=False)
            tr.start()
        elif tr.steps == 2:
            tr.stop()


@contextlib.contextmanager
def trace(logdir: str | None):
    """Timeline trace into ``logdir`` (``trace.json``, Chrome trace format,
    viewable in Perfetto): the whole block, or, where the block marks
    outer iterations with ``step()``, its second iteration only.

    ``logdir=None`` is a no-op, so callers can thread an optional CLI flag
    straight through:  ``with profiling.trace(args.profile): ...``.
    """
    if not logdir:
        yield
        return
    tr = _Trace(logdir)
    tr.start()
    _TRACES.append(tr)
    try:
        yield
    finally:
        _TRACES.remove(tr)
        if tr.prof is not None:
            tr.stop()
