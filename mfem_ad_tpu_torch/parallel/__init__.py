"""The multi-device layer on ``torch.distributed``: element-banded
assembly over the ranks of a process group.

PyTorch counterpart of ``mfem_ad_tpu.parallel``.  Two forms:

- ``ShardedForm``: the element axis in bands, dof vectors replicated, one
  sum all-reduce per assembly: any mesh.
- ``HaloShardedForm``: dof vectors distributed in the owner-zero layout;
  a matvec exchanges only the interface dof planes with the neighbouring
  ranks, O(surface) bytes.  Structured meshes.

``comm`` holds the communicator (``Comm``), ``init`` (join a group, or
read ``torchrun``'s environment) and ``spawn`` (start the ranks as
processes).  Several ranks on one GPU run over gloo; NCCL serves where
each rank has a GPU of its own.
"""

from .comm import Comm, default_backend, init, spawn, world
from .halo import HaloShardedForm
from .sharding import ShardedForm


def auto_sharded(form, comm=None):
    """The best sharded view of ``form``: the O(surface) halo layout where
    its constraints hold (structured spaces, outer cell count divisible by
    the rank count), else the replicated-dof ``ShardedForm`` (any mesh,
    any element count)."""
    try:
        return HaloShardedForm(form, comm)
    except (ValueError, NotImplementedError):
        return ShardedForm(form, comm)


__all__ = ["Comm", "HaloShardedForm", "ShardedForm", "auto_sharded",
           "default_backend", "init", "spawn", "world"]
