"""Device meshes for sharded validation, and the launch of one kernel a mesh
position.

The port's counterpart of the JAX package's `parallel/mesh.py`. Axis names
mirror the two parallelism axes the reference exposes (SURVEY.md §2.13):
"data" = the flattened (tx x sig) lane dimension (reference P1/P2,
goroutine-per-tx and per-endorsement verify loops), and "channel" = fully
independent per-channel validators (reference P3,
core/peer/peer.go:337-408).

`Mesh` holds an array of `torch.device`s, its axis names, and `.shape` as a
dict, as `jax.sharding.Mesh` does. The default pool is every CUDA device;
without a card it raises (no mesh lands on the CPU unless the caller lists
CPU devices).

Departure from a JAX mesh: a mesh may list one device more than once. Torch
has one CPU device and the card's machine one H100, so a repeated device is
how the split and the gather are held on the CPU and on the card. Each
position runs its own launch: on a CUDA device on a stream of its own
(`run_positions`), on the CPU the wrapper's plain version.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
CHANNEL_AXIS = "channel"


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: list CPU devices to build a mesh on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"no kernels for device {dev}")
    return dev


class Mesh:
    """An n-dimensional array of devices with a name for each axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        for idx in np.ndindex(self.devices.shape):
            self.devices[idx] = _device(self.devices[idx])
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"a {self.devices.ndim}-d device array needs {self.devices.ndim} axis names, "
                f"got {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def _along(self, names: Sequence[str]) -> np.ndarray:
        """The devices over the axes `names`, in that order, at index 0 of
        every other axis."""
        lead = [self.axis_names.index(n) for n in names]
        rest = [i for i in range(self.devices.ndim) if i not in lead]
        arr = np.transpose(self.devices, lead + rest)
        return arr.reshape(arr.shape[:len(lead)] + (-1,))[..., 0]

    def positions(self, axis: str) -> List[torch.device]:
        """The devices along `axis`, at index 0 of every other axis."""
        return list(self._along([axis]))

    def grid(self) -> np.ndarray:
        """The devices as a (channel, data) array; a mesh without a channel
        axis is one row."""
        if CHANNEL_AXIS in self.axis_names:
            return self._along([CHANNEL_AXIS, DATA_AXIS])
        return self._along([DATA_AXIS])[None, :]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def _device_pool(devices) -> List[torch.device]:
    if devices is not None:
        return [_device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices= to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def flat_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """One-dimensional mesh: every device on the "data" axis."""
    return Mesh(np.array(_device_pool(devices), dtype=object), axis_names=(DATA_AXIS,))


def grid_mesh(channel: int, data: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Two-dimensional (channel, data) mesh.

    `channel` groups of `data` devices each; defaults to using the whole
    pool (data = n // channel).
    """
    pool = _device_pool(devices)
    if data is None:
        if len(pool) % channel:
            raise ValueError(f"{len(pool)} devices not divisible into {channel} channel groups")
        data = len(pool) // channel
    if channel * data > len(pool):
        raise ValueError(f"mesh {channel}x{data} needs {channel * data} devices, have {len(pool)}")
    return Mesh(np.array(pool[: channel * data], dtype=object).reshape(channel, data),
                axis_names=(CHANNEL_AXIS, DATA_AXIS))


# ---------------------------------------------------------------------------
# One launch a mesh position
# ---------------------------------------------------------------------------

_streams: Dict[Tuple[int, torch.device], "torch.cuda.Stream"] = {}
_streams_lock = threading.Lock()


def _stream(position: int, device: torch.device) -> "torch.cuda.Stream":
    """The stream of a mesh position on a CUDA device, made on first use."""
    with _streams_lock:
        stream = _streams.get((position, device))
        if stream is None:
            stream = _streams[(position, device)] = torch.cuda.Stream(device=device)
        return stream


Launch = Callable[[torch.device], torch.Tensor]


def run_positions(jobs: Sequence[Tuple[torch.device, Launch]]) -> List[np.ndarray]:
    """Run each job's launch on its device and gather the masks to the host.

    A job is (device, launch): `launch(device)` copies its inputs to the
    device, launches its kernel and returns the (n,) bool mask. On a CUDA
    device it runs on a stream of its own (one a position), after the
    device's current stream (so inputs the caller queued there are ready);
    its inputs are made on that stream, so the allocator reuses them only
    behind it; its mask is copied to pinned host memory behind the launch.
    Every launch is queued before the first wait, so the positions on one
    card overlap. On the CPU the launch runs the plain version. A failed
    launch or copy raises; no partial mask is returned."""
    pending = []
    for position, (device, launch) in enumerate(jobs):
        if device.type != "cuda":
            pending.append((None, launch(device).numpy()))
            continue
        stream = _stream(position, device)
        with torch.cuda.device(device):
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                mask = launch(device)
                host = torch.empty(mask.shape, dtype=torch.bool, pin_memory=True)
                host.copy_(mask, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
        pending.append((done, host))
    out = []
    for done, host in pending:
        if done is not None:
            done.synchronize()
            host = host.numpy()
        out.append(np.array(host, dtype=bool))
    return out
