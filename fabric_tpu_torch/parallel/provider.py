"""Mesh-aware BCCSP provider: one channel's (tx x sig) batch spread over
every device on the mesh's "data" axis (SURVEY.md §2.13 P2 -> P6).

The port's counterpart of the JAX package's `parallel/provider.py`
`MeshTPUProvider`, which overrides only `_run_kernel`. Its `batch_verify`
is the parent's: in the reference that is `TPUProvider.batch_verify` ->
`batch_verify_async` -> `_dispatch_bytes`, one unsharded K2 launch a batch
(`fabric_tpu/crypto/tpu_provider.py:142-156, :182, :346`), and
`_run_kernel` (`:424`) has no caller in the package. The port keeps that:
`MeshCUDAProvider.batch_verify` is `CUDAProvider`'s, one K2 launch a batch,
and `_run_kernel` runs the limb route (K1) sharded.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider, _bucket, _pad
from fabric_tpu_torch.parallel.mesh import Mesh, flat_mesh
from fabric_tpu_torch.parallel.sharded import ShardedVerify, pad_lanes


class MeshCUDAProvider(CUDAProvider):
    """CUDAProvider whose limb-route batches run sharded over a mesh.

    Occupies the same bccsp-factory slot as CUDAProvider; buckets are
    additionally aligned to the data-axis size so every shard gets equal
    work. The host prep runs for the mesh's first device. Without a card,
    `MeshCUDAProvider()` raises (its default mesh is every CUDA device)."""

    def __init__(self, mesh: Optional[Mesh] = None):
        if mesh is None:
            mesh = flat_mesh()
        self.sharded = ShardedVerify(mesh)
        super().__init__(device=mesh.grid()[0, 0])

    def _run_kernel(self, limbs: Sequence[np.ndarray]) -> List[bool]:
        """The limb route's (e, r, s, qx, qy) (20, n) limbs and (n,) mask,
        padded with dead lanes to the bucket and verified over the mesh."""
        n = limbs[-1].shape[0]
        size = pad_lanes(_bucket(n), self.sharded.data_size)
        *cols, ok = limbs
        out = self.sharded.verify_flat(*(_pad(c, size, axis=1) for c in cols),
                                       _pad(ok.astype(bool), size))
        with self._lock:  # one K1 launch a position on the card
            self.launches["p256_verify_limbs"] += sum(
                d.type == "cuda" for d in self.sharded.mesh.grid()[0])
        return [bool(v) for v in out[:n]]
