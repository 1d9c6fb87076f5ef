"""Host copies of arrays and tensors for the writers."""

from __future__ import annotations

import numpy as np
import torch


def to_numpy(v) -> np.ndarray:
    """A numpy array of ``v``: a tensor is detached and copied to the
    host, anything else goes through ``np.asarray``."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)
