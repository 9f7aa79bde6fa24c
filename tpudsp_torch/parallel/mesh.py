"""The (channel, time) mesh of the sharded runtime (port of
``tpudsp/parallel/mesh.py``).

- ``channel`` axis: independent receiver chains, no communication.
- ``time`` axis: one long IQ stream split across ranks; FIR front ends
  exchange input halos with the left neighbour (``halo.py``), feedback
  loops re-derive their entry state from a warmup-sized halo, and linear
  recurrences cross ranks through a gathered prefix (``bank.py``).

A mesh of more than one rank is PyTorch's ``DeviceMesh`` with
``mesh_dim_names=("channel", "time")``, over the default process group
(NCCL on the card, gloo on the CPU); each axis's group comes from
``mesh.get_group(axis)``. A 1x1 mesh is ``LocalMesh``: this process alone,
with no process group, so a single card needs no rendezvous; the time
halo then degenerates to the block-carried fill, as JAX's ``left_halo``
does on a one-shard axis.

JAX's ``to_varying`` and ``bank_sharding`` have no counterpart: the first
exists only for shard_map's replication checks, the second names a global
array's layout, and here every rank holds its own slice.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

CHANNEL_AXIS = "channel"
TIME_AXIS = "time"


class LocalMesh:
    """The 1x1 (channel, time) mesh: this process alone. It answers the
    part of ``DeviceMesh``'s interface the runtime uses, with no process
    group behind it."""

    mesh_dim_names = (CHANNEL_AXIS, TIME_AXIS)

    def __init__(self, device_type: str):
        self.device_type = device_type

    def size(self, mesh_dim=None) -> int:
        return 1

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0

    def get_group(self, mesh_dim=None):
        return None


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis`` (``DeviceMesh.size`` takes the
    axis's index)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def make_mesh(n_channel: int = 1, n_time: int = 1, device="cuda"):
    """A (channel, time) mesh of n_channel x n_time ranks on ``device``'s
    type ("cuda" unless the caller asks for "cpu"). More than one rank
    needs the default process group, one rank per process; the caller
    initialises it (``torchrun`` sets the environment that
    ``init_device_mesh`` reads otherwise)."""
    device_type = torch.device(device).type
    need = n_channel * n_time
    if need == 1:
        return LocalMesh(device_type)
    if dist.is_initialized() and dist.get_world_size() != need:
        raise ValueError(f"need {need} ranks, the process group has "
                         f"{dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (n_channel, n_time),
                            mesh_dim_names=(CHANNEL_AXIS, TIME_AXIS))
