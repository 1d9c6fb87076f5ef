"""Tables and vectors from numpy arrays, for computing in both packages
from the very same data.

``tables_from_numpy`` takes a JAX integrator's ``tables`` with every leaf
as a numpy array (``jax.tree_util.tree_map(np.asarray, intg.tables)``) and
returns the port's tables dictionary, ready for
``ADBlockIntegrator(..., tables=...)``: element-varying B, w and statics
(the pullback's ``_invj``) and the transpose-gather table ``einv`` come
across as they are.

The tables of a ``DofPGIntegrator`` nest an integrator's under "inner"
beside tuples of arrays and tuples of dicts (``wn``, ``edof_p``,
``edof_d``, ``static``, ``efield``); they cross leaf by leaf, the inner
tables by the rules above.

``dist_blocks_from_numpy`` and ``numpy_from_dist_blocks`` carry the halo
layout across: the JAX package's ``HaloShardedForm`` holds a distributed
vector as one array of K * slots entries, the port's as one slot block
per rank (``parallel.HaloShardedForm.dist_array``), in rank order.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils._host import to_numpy

# the planar 3D assembly's factor, consumed by a route the port does not
# have (``element_matrices`` contracts against W0)
_UNPORTED = ("W0p",)


def _leaf(a, device, dtype):
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _tree(val, device, dtype):
    """Leaves of nested tuples, lists and dicts as tensors."""
    if isinstance(val, (tuple, list)):
        return tuple(_tree(v, device, dtype) for v in val)
    if isinstance(val, dict):
        return {k: _tree(v, device, dtype) for k, v in val.items()}
    return _leaf(val, device, dtype)


def tables_from_numpy(tables: dict, device, dtype: torch.dtype) -> dict:
    if "inner" in tables:  # a DofPGIntegrator's
        return {key: (tables_from_numpy(val, device, dtype) if key == "inner"
                      else _tree(val, device, dtype))
                for key, val in tables.items()}
    out = {}
    for key, val in tables.items():
        if key == "field":  # name -> (edof, phi): phi and "field_edof"
            out[key] = {k: _leaf(pair[1], device, dtype)
                        for k, pair in val.items()}
            out["field_edof"] = {k: _leaf(pair[0], device, dtype)
                                 for k, pair in val.items()}
            continue
        if key not in _UNPORTED:
            out[key] = _tree(val, device, dtype)
    # element-varying shape tensors: the JAX package installs no W0 / W
    for key in ("W0", "W"):
        out.setdefault(key, {})
    return out


def vector_from_numpy(v, device, dtype: torch.dtype) -> torch.Tensor:
    """A dof or state vector as a tensor."""
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)


def dist_blocks_from_numpy(ud, n_ranks: int, device,
                           dtype: torch.dtype) -> list[torch.Tensor]:
    """A JAX halo-layout vector (length K * slots) as the port's per-rank
    slot blocks, rank 0 first."""
    return [vector_from_numpy(b, device, dtype)
            for b in np.asarray(ud).reshape(n_ranks, -1)]


def numpy_from_dist_blocks(blocks) -> np.ndarray:
    """The port's per-rank slot blocks (rank order) as the JAX halo-layout
    vector."""
    return np.concatenate([to_numpy(b) for b in blocks])
