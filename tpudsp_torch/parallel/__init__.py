"""The sharded runtime (port of ``tpudsp/parallel/``) on
``torch.distributed``: the (channel, time) mesh, the time-axis halo
exchange, the cross-shard helpers of the bank runtime and the
time-sharded AM receiver. NCCL carries the collectives between cards,
gloo between CPU processes; a 1x1 mesh needs no process group.

Not ported yet (ROADMAP.md Queue A #12): ``ShardedBank`` (after the bank
chain, Queue A #9), ``channelizer``, ``pipeline``, ``multihost`` and
``elastic``."""

from .am import SAMState, ShardedAMReceiver
from .mesh import CHANNEL_AXIS, TIME_AXIS, LocalMesh, make_mesh

__all__ = ["CHANNEL_AXIS", "TIME_AXIS", "LocalMesh", "make_mesh",
           "SAMState", "ShardedAMReceiver"]
