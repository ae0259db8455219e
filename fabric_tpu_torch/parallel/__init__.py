"""Multi-device and multi-channel execution (SURVEY.md §2.13 P3/P6).

The reference scales by channel-level process parallelism
(core/peer/peer.go:337-408: independent Channel objects) and per-tx
goroutines. The port's counterparts:

- `mesh`: device meshes ("data" and "channel" axes) and the launch of one
  kernel a mesh position, a stream a position on the card.
- `sharded.ShardedVerify`: K1 split over a mesh, lanes over "data" and
  channels over "channel", masks gathered to the host.
- `provider.MeshCUDAProvider`: the BCCSP provider whose limb-route batches
  run sharded (its `batch_verify` is `CUDAProvider`'s, one K2 launch).
- `multichannel.MultiChannelValidator`: one block per channel, every
  channel's signatures in one K1 launch, or one a mesh position
  (BASELINE config #5: 4 channels x 2k tx).
- `batcher.VerifyBatcher`: cross-channel verify coalescing with bounded
  backpressure (P7), few large launches instead of many small ones.
"""

from fabric_tpu_torch.parallel.mesh import (
    CHANNEL_AXIS,
    DATA_AXIS,
    flat_mesh,
    grid_mesh,
)
from fabric_tpu_torch.parallel.sharded import ShardedVerify
from fabric_tpu_torch.parallel.provider import MeshCUDAProvider
from fabric_tpu_torch.parallel.multichannel import MultiChannelValidator
from fabric_tpu_torch.parallel.batcher import BatchingProvider, VerifyBatcher

__all__ = [
    "BatchingProvider",
    "flat_mesh",
    "grid_mesh",
    "ShardedVerify",
    "MeshCUDAProvider",
    "MultiChannelValidator",
    "VerifyBatcher",
]
