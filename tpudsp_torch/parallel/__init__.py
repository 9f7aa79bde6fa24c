"""The sharded runtime (port of ``tpudsp/parallel/``) on
``torch.distributed``: the (channel, time) mesh, the time-axis halo
exchange, the time-sharded AM receiver, the sharded receiver bank, the
channelizer with its transform split across ranks and its demod bank,
the wideband scanner (BASELINE config 5), the two-stage pipelined AM
receiver and the elastic recovery runner. NCCL carries the collectives
between cards, gloo between CPU processes; a 1x1 mesh needs no process
group. ``init_distributed`` joins the default group from its arguments
or ``torchrun``'s environment."""

from .am import SAMState, ShardedAMReceiver
from .bank import ShardedBank, sharded_bank_step
from .channelizer import ShardedChannelizedBank, ShardedChannelizer, channel_layout
from .elastic import ElasticRunner
from .mesh import CHANNEL_AXIS, TIME_AXIS, LocalMesh, make_mesh
from .multihost import ShardedScanner, init_distributed
from .pipeline import PipelinedAMReceiver, make_stage_mesh

__all__ = ["CHANNEL_AXIS", "TIME_AXIS", "LocalMesh", "make_mesh",
           "SAMState", "ShardedAMReceiver", "ShardedBank", "sharded_bank_step",
           "ShardedChannelizer", "ShardedChannelizedBank", "channel_layout",
           "ShardedScanner", "init_distributed", "PipelinedAMReceiver",
           "make_stage_mesh", "ElasticRunner"]
