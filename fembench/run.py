"""The benchmark of ``mfem_ad_tpu_torch`` on one NVIDIA GPU.

    python3 fembench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  One run: set-up (the cell's problem built and
its inputs made on the device from the seed, its shapes warmed), a window
of whole units back to back, then the output check against the plain
reference once the program's state is freed.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, ``host`` (the main thread's CPU share of
the window and the cores' clock as the host reports it, beside each run)
and, last, ``check``: each number compared beside its limit, which also
closes standard error.  Without a CUDA device,
or with JAX or the JAX package loaded, it exits with an error and prints no
result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

import harness  # noqa: E402


def _finite(v: float) -> float:
    """A number JSON can carry: a non-finite reading becomes the largest
    double (it fails its limit either way)."""
    return v if math.isfinite(v) else math.copysign(1.7976931348623157e308,
                                                    1.0 if v != v else v)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             cfg_override: dict | None = None, clock=harness.now,
             t_start: float | None = None, control: bool = False) -> dict:
    """One run of ``cell``; returns the result object.  ``cfg_override``
    (the tests' tiny sizes) updates the configuration; ``clock`` times the
    window."""
    import torch

    bench = harness.benchmark()
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = clock() if t_start is None else t_start
    wl, cfg, traffic = harness.build(cell, device, control, cfg_override)
    traffic.inputs(seed, seconds)
    traffic.warm()
    sync()
    rec = harness.Record(cfg)
    rec.setup_s = clock() - t0
    spans = harness.CudaSpans(torch) if cuda else harness.NoSpans()
    if trace:
        traffic.instrument(rec, spans)
    cpu0 = time.thread_time()
    rec.window_s, rec.units, rec.work = harness.window(
        traffic, seconds, clock, sync)
    cpu_share = (time.thread_time() - cpu0) / rec.window_s
    memory_peak = rec.memory_peak = (torch.cuda.max_memory_allocated()
                                     if cuda else 0)
    breakdown = None
    if trace:
        spans.flush(rec)
        traffic.uninstrument()
        rec.profile, _ = harness.profile_slice(torch, traffic.slice, sync,
                                               harness.now)
        rec.profile["units"] = traffic.slice_units
        breakdown = {"device_ops": rec.profile["device_ops"],
                     "idle_gaps": rec.profile["idle_gaps"]}
    traffic.release()
    if cuda:
        torch.cuda.empty_cache()
    checks = traffic.check(wl["limits"])
    metrics = {}
    for m in harness.metrics_of(bench, cell, per_layer=bool(trace)):
        value = harness.load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    if trace:
        dev["busy_s"] = rec.profile["busy_s"]
        dev["window_s"] = rec.profile["window_s"]
    out = {"correct": harness.passed(checks), "attempted": rec.units,
           "failed": traffic.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["host"] = {"window_cpu_share": cpu_share, "cpu_mhz": _cpu_mhz()}
    out["check"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                    for k, v in harness.check_line(checks).items()}
    return out


def _cpu_mhz() -> float | None:
    """The mean clock of the host's cores as /proc/cpuinfo reports it
    (a virtual machine may report a constant)."""
    try:
        with open("/proc/cpuinfo") as fh:
            mhz = [float(line.split(":")[1]) for line in fh
                   if line.startswith("cpu MHz")]
    except OSError:
        return None
    return sum(mhz) / len(mhz) if mhz else None


def _power_limit() -> str:
    """The card's power limit as nvidia-smi reads it (a card set below
    700 W runs slower under load)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches at fixed places inside the checkout (the program's nvcc
    # builds go to mfem_ad_tpu_torch/_build/ there)
    cache = os.path.join(ROOT, ".fembench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    import torch

    chips = {w["name"]: w["chips"] for w in harness.benchmark()["workloads"]
             }[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"fembench: needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"fembench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(f"card: {out['device']['kind']}, power limit {_power_limit()}",
          file=sys.stderr)
    started = time.gmtime(time.time() - (time.perf_counter() - T_START))
    print(f"host: started {time.strftime('%Y-%m-%dT%H:%M:%SZ', started)}, "
          f"the main thread's CPU share of the window "
          f"{out['host']['window_cpu_share']!r}, cpu MHz "
          f"{out['host']['cpu_mhz']!r}", file=sys.stderr)
    for name, c in out["check"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
