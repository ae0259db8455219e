"""The batched ECDSA-P256 verify (K1) split over a device mesh, and the
channel stacking of the multi-channel verify.

The port's counterpart of the JAX package's `parallel/sharded.py`. Two
entry points of `ShardedVerify`:

- `verify_flat`: one channel's (tx x sig) batch, its lanes split over the
  mesh's "data" axis;
- `verify_channels`: a (channel, lane) stack, channels split over
  "channel" and lanes over "data" (reference channel objects are fully
  independent, core/peer/peer.go:337-408).

Each mesh position runs ONE K1 launch (`ops/p256_kernel.verify_batch`,
`p256_verify_limbs`) over its slice of lanes; for `verify_channels` its
block of channels x lanes laid end to end, as `parallel/multichannel.py`
lays a stack for one launch. The masks are gathered to the host
(`mesh.run_positions`: a stream a position on the card). Where the JAX
program replicates `verify_flat` over a channel axis, the port runs the
mesh's first channel row only: every row would compute the same mask.
Shapes must divide the mesh: lanes % data-axis == 0 and channels %
channel-axis == 0 (`pad_lanes`), with the JAX package's errors.
"""

from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import numpy as np
import torch

from fabric_tpu_torch.common.limbparams import NLIMBS
from fabric_tpu_torch.ops import p256_kernel as pk
from fabric_tpu_torch.parallel.mesh import CHANNEL_AXIS, DATA_AXIS, Mesh, run_positions


def pad_lanes(n: int, multiple: int) -> int:
    """`n` rounded up to a multiple of `multiple`."""
    return ((n + multiple - 1) // multiple) * multiple


def _k1_launch(arrays: Sequence[np.ndarray]):
    """The launch of one position: its (20, n) limb columns and (n,) mask
    copied to the device, then K1 (its plain version on the CPU)."""

    def launch(device: torch.device) -> torch.Tensor:
        return pk.verify_batch(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                                 for a in arrays))

    return launch


class ShardedVerify:
    """K1 over a mesh: one launch a position, masks gathered to the host."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    @property
    def data_size(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    @property
    def channel_size(self) -> int:
        return self.mesh.shape.get(CHANNEL_AXIS, 1)

    def verify_flat(self, e: np.ndarray, r: np.ndarray, s: np.ndarray, qx: np.ndarray,
                    qy: np.ndarray, ok: np.ndarray) -> np.ndarray:
        """(20, B) int64 limb arrays + (B,) mask -> (B,) bool, B % data == 0."""
        if e.shape[1] % self.data_size:
            raise ValueError(
                f"lane count {e.shape[1]} not divisible by data axis {self.data_size}")
        w = e.shape[1] // self.data_size
        jobs = [(device, _k1_launch([a[..., j * w:(j + 1) * w] for a in (e, r, s, qx, qy, ok)]))
                for j, device in enumerate(self.mesh.grid()[0])]
        return np.concatenate(run_positions(jobs))

    def verify_channels(self, e: np.ndarray, r: np.ndarray, s: np.ndarray, qx: np.ndarray,
                        qy: np.ndarray, ok: np.ndarray) -> np.ndarray:
        """(C, 20, B) int64 limb stacks + (C, B) mask -> (C, B) bool."""
        c, _, b = e.shape
        if b % self.data_size or c % self.channel_size:
            raise ValueError(
                f"stack ({c}, {b}) not divisible by mesh "
                f"({self.channel_size}, {self.data_size})")
        cw, w = c // self.channel_size, b // self.data_size
        grid = self.mesh.grid()
        blocks = list(itertools.product(range(self.channel_size), range(self.data_size)))
        jobs = []
        for i, j in blocks:
            rows, lanes = slice(i * cw, (i + 1) * cw), slice(j * w, (j + 1) * w)
            # (cw, 20, w) -> (20, cw * w): the block's channels end to end
            arrays = [a[rows, :, lanes].transpose(1, 0, 2).reshape(NLIMBS, -1)
                      for a in (e, r, s, qx, qy)]
            arrays.append(ok[rows, lanes].reshape(-1))
            jobs.append((grid[i, j], _k1_launch(arrays)))
        out = np.zeros((c, b), dtype=bool)
        for (i, j), mask in zip(blocks, run_positions(jobs)):
            out[i * cw:(i + 1) * cw, j * w:(j + 1) * w] = mask.reshape(cw, w)
        return out


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
