"""Readings of a cell's output check over many seeds in one process, for
setting its limits: the program's (the lower readings) or, with
``--control``, the control's (the upper readings).

    python3 fembench/readings.py --workload <cell> --seeds 11 12 13 \
        [--control] [--units N]

The cell is built once; each seed gets its own inputs, a warm-up, the
units whose outputs a run would compare (at least ``--units``), and the
same check as a run.  One JSON line per seed on standard output.  The
benchmark's runs never call this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import harness  # noqa: E402


def readings(cell: str, seeds, control: bool, units: int, device,
             cfg_override: dict | None = None):
    """Yield one record per seed: the compared numbers and the limits."""
    import torch

    wl, cfg, traffic = harness.build(cell, device, control, cfg_override)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for seed in seeds:
        traffic.inputs(seed, 1.0)
        traffic.warm()
        rec = harness.Record(cfg)
        spans = harness.CudaSpans(torch) if cuda else harness.NoSpans()
        traffic.instrument(rec, spans)
        t0 = time.perf_counter()
        for k in range(max(units, traffic.need_units)):
            traffic.unit(k)
        sync()
        seconds = time.perf_counter() - t0
        spans.flush(rec)
        traffic.uninstrument()
        checks = traffic.check(wl["limits"])
        yield {"cell": cell, "seed": seed, "control": control,
               "seconds": seconds, "failed": traffic.failed,
               "check": harness.check_line(checks),
               "counters": rec.counters,
               "spans_mean_s": {k: sum(v) / len(v)
                                for k, v in rec.spans.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--units", type=int, default=1)
    args = ap.parse_args(argv)
    for rec in readings(args.workload, args.seeds, args.control, args.units,
                        "cuda"):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
