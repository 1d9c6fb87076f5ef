"""Checkpoint/resume for long outer loops: save named arrays or tensors
(u, psi_k, alpha, iter, ...) as a .npz plus a JSON sidecar of scalars, so
a run can resume.  Tensors are copied to the host; arrays load back as
numpy."""

from __future__ import annotations

import json
import os

import numpy as np

from ._host import to_numpy


def save_checkpoint(path: str, arrays: dict, meta: dict | None = None):
    """Save named arrays (+ JSON-serializable metadata) atomically.

    The JSON sidecar is written (atomically) BEFORE the arrays are
    published, so a crash at any point leaves either the previous complete
    checkpoint or the new complete one — never a newer .npz with a stale
    or truncated sidecar.
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    final = path if path.endswith(".npz") else path + ".npz"
    if meta is not None:
        tmpj = final + ".json.tmp"
        with open(tmpj, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmpj, final + ".json")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{k: to_numpy(v) for k, v in arrays.items()})
    os.replace(tmp, final)
    return final


def load_checkpoint(path: str):
    """Returns (arrays: dict, meta: dict|None).

    A missing or corrupt JSON sidecar yields ``meta=None`` (callers fall
    back to iteration 0) rather than raising.
    """
    final = path if path.endswith(".npz") else path + ".npz"
    with np.load(final) as z:
        arrays = {k: z[k] for k in z.files}
    meta = None
    if os.path.exists(final + ".json"):
        try:
            with open(final + ".json") as f:
                meta = json.load(f)
        except (json.JSONDecodeError, OSError):
            meta = None
    return arrays, meta
