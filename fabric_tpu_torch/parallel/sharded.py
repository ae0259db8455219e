"""Channel stacking for the multi-channel verify, on one device.

The port's counterpart of `pad_lanes` and `channel_stack` of the JAX
package's `parallel/sharded.py`. The JAX module shards the stack over a
device mesh (`ShardedVerify`); the port runs on one H100, where
`parallel/multichannel.py` lays the stacked channels end to end for one K1
launch. `ShardedVerify` and the mesh come with the multi-device wrappers.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from fabric_tpu_torch.common.limbparams import NLIMBS


def pad_lanes(n: int, multiple: int) -> int:
    """`n` rounded up to a multiple of `multiple`."""
    return ((n + multiple - 1) // multiple) * multiple


def channel_stack(
    batches: Sequence[Tuple[np.ndarray, ...]],
    lanes: int,
    channels: int,
) -> Tuple[np.ndarray, ...]:
    """Pad each channel's (e, r, s, qx, qy, ok) arrays ((20, n) int64 limbs,
    (n,) bool) to `lanes` lanes and stack them to (channels, 20, lanes) and
    (channels, lanes), with dead (ok False) rows for the missing channels."""
    if len(batches) > channels:
        raise ValueError(f"{len(batches)} channels do not fit a stack of {channels}")
    out_limbs = [np.zeros((channels, NLIMBS, lanes), dtype=np.int64) for _ in range(5)]
    out_ok = np.zeros((channels, lanes), dtype=bool)
    for c, (*limb_arrays, ok) in enumerate(batches):
        n = ok.shape[0]
        if n > lanes:
            raise ValueError(f"channel {c} has {n} lanes, more than {lanes}")
        for dst, src in zip(out_limbs, limb_arrays):
            dst[c, :, :n] = src
        out_ok[c, :n] = ok
    return (*out_limbs, out_ok)
