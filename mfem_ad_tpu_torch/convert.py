"""Tables and vectors from numpy arrays, for computing in both packages
from the very same data.

``tables_from_numpy`` takes a JAX integrator's ``tables`` with every leaf
as a numpy array (``jax.tree_util.tree_map(np.asarray, intg.tables)``) and
returns the port's tables dictionary, ready for
``ADBlockIntegrator(..., tables=...)``: element-varying B, w and statics
(the pullback's ``_invj``) and the transpose-gather table ``einv`` come
across as they are.
"""

from __future__ import annotations

import numpy as np
import torch

# the planar 3D assembly's factor, consumed by a route the port does not
# have (``element_matrices`` contracts against W0)
_UNPORTED = ("W0p",)


def _leaf(a, device, dtype):
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def tables_from_numpy(tables: dict, device, dtype: torch.dtype) -> dict:
    out = {}
    for key, val in tables.items():
        if key == "field":  # name -> (edof, phi): phi and "field_edof"
            out[key] = {k: _leaf(pair[1], device, dtype)
                        for k, pair in val.items()}
            out["field_edof"] = {k: _leaf(pair[0], device, dtype)
                                 for k, pair in val.items()}
            continue
        if key in _UNPORTED:
            continue
        if isinstance(val, (tuple, list)):
            out[key] = tuple(_leaf(v, device, dtype) for v in val)
        elif isinstance(val, dict):
            out[key] = {k: _leaf(v, device, dtype) for k, v in val.items()}
        else:
            out[key] = _leaf(val, device, dtype)
    # element-varying shape tensors: the JAX package installs no W0 / W
    for key in ("W0", "W"):
        out.setdefault(key, {})
    return out


def vector_from_numpy(v, device, dtype: torch.dtype) -> torch.Tensor:
    """A dof or state vector as a tensor."""
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
