"""The generic part of the benchmark: finding a cell's pieces by name,
the measured window, the profiled slice and the result line.

Everything that belongs to one configuration, traffic kind or metric lives
in a file of its own under ``fembench/``, found by the name that
``BENCHMARK.json`` gives it:

    configs/<config>.json     the problem, its precision, what is assumed
    workloads/<cell>.json     the config, the traffic kind, its parameters
                              and the limits of the output check
    traffic/<kind>.py         ``Traffic``: build, seed inputs, warm, unit,
                              spans, profiled slice, output check
    metrics/<metric>.py       ``read(rec)``: one metric from a ``Record``
    reference/<config>.py     the plain reference (or the one that the
                              configuration names under "reference")
    counts/<name>.py          frozen operation and byte counts
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "mfem_ad_tpu")


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """The module ``fembench/<kind>/<name>.py``, else, for a dotted name
    such as ``vcycle_ms.pg``, the one of the part before the first dot:
    one reader serves a quantity split by the cells that report it.
    Names may hold dots and dashes, so it is loaded by path."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.isfile(path) and "." in name:
        name = name.split(".")[0]
        path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    key = f"fembench_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def build(cell: str, device, control: bool = False,
          cfg_override: dict | None = None):
    """(workload, configuration, traffic) of ``cell``: its files found by
    name, the configuration updated by ``cfg_override`` (the tests' tiny
    sizes), the traffic built with the configuration's reference: the
    module it names under "reference", else the one of its own name."""
    wl = load_json("workloads", cell)
    cfg = {**load_json("configs", wl["config"]), **(cfg_override or {})}
    ref = load_module("reference", cfg.get("reference", wl["config"]))
    traffic = load_module("traffic", wl["traffic"]).Traffic(
        cfg, wl["params"], device, ref, control=control)
    return wl, cfg, traffic


def metrics_of(bench: dict, cell: str, per_layer: bool) -> list[dict]:
    """The metrics that ``cell`` reports: the end-to-end ones listed for
    it (or for every cell), or the per-layer ones listed for it (or, with
    no list, for every cell that reports the metric they move)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not per_layer:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``mfem_ad_tpu_torch`` is not
    ``mfem_ad_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Record:
    """What one run measured: the window, and in a traced run the spans,
    counters and profiled slice that the per-layer readers read."""

    cfg: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0
    work: float = 0.0
    memory_peak: int = 0                           # bytes, read after the window
    spans: dict = field(default_factory=dict)      # name -> [seconds]
    counters: dict = field(default_factory=dict)   # name -> [values]
    profile: dict | None = None

    def span(self, name: str, seconds: float):
        self.spans.setdefault(name, []).append(seconds)

    def count(self, name: str, value: float):
        self.counters.setdefault(name, []).append(value)


class CudaSpans:
    """CUDA-event spans: ``wrap(fn, name, when)`` times the calls for which
    ``when(*args)`` holds on the device; ``flush(rec)`` waits for the
    events and records their seconds."""

    def __init__(self, torch):
        self.torch = torch
        self.pending = []

    def wrap(self, fn, name: str, when=lambda *a, **k: True):
        torch = self.torch

        def timed(*args, **kwargs):
            if not when(*args, **kwargs):
                return fn(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.pending.append((name, start, end))
            return out

        return timed

    def flush(self, rec: Record):
        for name, start, end in self.pending:
            end.synchronize()
            rec.span(name, start.elapsed_time(end) / 1e3)
        self.pending.clear()


class NoSpans:
    """Stands in for ``CudaSpans`` without a card (the tests): times
    nothing."""

    def wrap(self, fn, name: str, when=None):
        return fn

    def flush(self, rec: Record):
        pass


def window(traffic, seconds: float, clock, sync) -> tuple[float, int, float]:
    """Whole units back to back: another starts only while one more of the
    mean length so far still fits into ``seconds``; at least one runs.
    Returns (seconds from the first start to the closing sync, units, work)."""
    sync()
    t0 = clock()
    units, work = 0, 0.0
    while True:
        work += traffic.unit(units)
        units += 1
        elapsed = clock() - t0
        if elapsed + elapsed / units > seconds:
            break
    sync()
    return clock() - t0, units, work


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_slice(torch, fn, sync, clock) -> tuple[dict, object]:
    """Run ``fn`` once under torch.profiler and reduce the trace: the
    union of device activity (busy_s), the host wall of the slice
    (window_s), device time by operation, and the idle gaps by the
    innermost host span open at their middle; and what ``fn`` returned.
    Nothing is written to disk."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = clock()
        out = fn()
        sync()
        wall = clock() - t0
    dev, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            host.append((tr.start, tr.end, ev.name))
        elif not getattr(ev, "is_user_annotation", False):
            # kernels, copies and fills; a span's device-side shadow is not
            # an operation
            dev.append((ev.name, tr.start, tr.end))
    spans = {name for _, _, name in host if "/" in name}
    dev = [d for d in dev if d[0] not in spans]
    by_op: dict = {}
    for name, s, e in dev:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e6
    busy = _merged([(s, e) for _, s, e in dev])
    gaps: dict = {}
    host.sort()
    stack, i = [], 0     # host spans open at the sweep's time, innermost last
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "(no host span)"
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) / 1e6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "window_s": wall,
        "device_s": sum(by_op.values()),
        "launches": len(dev),
        "device_ops": [[k, v] for k, v in top],
        "idle_gaps": [[k, v] for k, v in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:10]],
    }, out


def worst(a: float, b: float) -> float:
    """The larger of two readings; NaN where either is NaN."""
    return a if a != a or a > b else b


def check_line(checks) -> dict:
    """{name: {"value", "limit"}} of the compared numbers."""
    return {name: {"value": value, "limit": limit}
            for name, value, limit in checks}


def passed(checks) -> bool:
    """Each number at or under its limit (NaN fails)."""
    return all(value <= limit for _, value, limit in checks)


def now() -> float:
    return time.perf_counter()
