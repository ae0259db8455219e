"""Multi-channel validation with one signature launch (BASELINE config #5:
4 channels x 2k-tx blocks).

The port's counterpart of the JAX package's `parallel/multichannel.py`.
The reference validates each channel in its own Channel object
(core/peer/peer.go:337-408). Here one block per channel is parsed and its
signature jobs collected on the host, each channel's lanes are stacked
(`parallel/sharded.channel_stack`) and laid end to end, and ONE K1 launch
(`ops/p256_kernel.verify_batch`, `p256_verify_limbs`) verifies every
channel's signatures: the counterpart of the JAX package's
`jax.jit(jax.vmap(verify_batch_device))` over a channel axis
(`parallel/sharded.py:69-85`). Each channel then finishes its host phases
(principal matching, policy circuits, duplicate txids) in its own
`BlockValidator`, as on the single-channel path. Without a mesh the
channel axis is a stretch of lanes. With one (`mesh=`, the JAX
constructor's `mesh`, `fabric_tpu/parallel/multichannel.py:31-33`; a keyword
here, after the validators, so that callers without a mesh keep working)
the stack goes through `ShardedVerify.verify_channels`: one K1 launch a mesh
position over its channels' block of lanes.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from fabric_tpu_torch.common.limbparams import NLIMBS
from fabric_tpu_torch.common.txflags import ValidationFlags
from fabric_tpu_torch.crypto.cuda_provider import CUDAProvider, _bucket
from fabric_tpu_torch.ops import p256_kernel as pk
from fabric_tpu_torch.parallel.mesh import Mesh
from fabric_tpu_torch.parallel.sharded import ShardedVerify, channel_stack, pad_lanes
from fabric_tpu_torch.validation.blockparse import parse_block
from fabric_tpu_torch.validation.validator import BlockValidator


class MultiChannelValidator:
    """Validates one block per channel, every channel's signatures in one
    K1 launch on `device` (the card unless the caller asks for "cpu", where
    K1's plain version runs), or in one K1 launch a position of `mesh`."""

    sharded: Optional[ShardedVerify] = None  # K1 over the mesh, when there is one

    def __init__(self, validators: Dict[str, BlockValidator], device=None,
                 mesh: Optional[Mesh] = None):
        self.validators = dict(validators)
        if mesh is not None:
            self.sharded = ShardedVerify(mesh)
        if device is None:
            device = mesh.grid()[0, 0] if mesh is not None else "cuda"
        # the host prep (native DER parse, key-limb cache) shared by the channels
        self._prep = CUDAProvider(device=device)
        # launch to mask on the host, the last validate's K1 step (copies
        # included), in milliseconds
        self.last_device_ms = 0.0
        # per channel: parse, collect (identities, digests), prep_limbs and
        # epilogue (finish_sig_results and validate) milliseconds
        self.last_split_ms: Dict[str, Dict[str, float]] = {}

    def validate(self, blocks: Dict[str, dict]) -> Dict[str, ValidationFlags]:
        channels = sorted(blocks)
        unknown = [c for c in channels if c not in self.validators]
        if unknown:
            raise KeyError(f"no validator for channels {unknown}")

        per_channel, split = {}, {}
        for ch in channels:
            validator, block = self.validators[ch], blocks[ch]
            t0 = time.perf_counter()
            parsed = parse_block(list(block.get("data", {}).get("data", ())))
            t1 = time.perf_counter()
            jobs, job_identity, keys, sigs, digests = validator.collect_sig_jobs(parsed)
            t2 = time.perf_counter()
            limbs = self._prep.prep_limbs(keys, sigs, digests)
            t3 = time.perf_counter()
            per_channel[ch] = (validator, block, parsed, jobs, job_identity, limbs)
            split[ch] = {"parse": (t1 - t0) * 1e3, "collect": (t2 - t1) * 1e3,
                         "prep_limbs": (t3 - t2) * 1e3}

        # each channel's stretch of lanes starts on a K1 block boundary
        widest = max(per_channel[ch][5][-1].shape[0] for ch in channels)
        data = self.sharded.data_size if self.sharded else 1
        lanes = pad_lanes(_bucket(max(widest, 1)), pk.LANES_PER_BLOCK * data)
        n_stack = pad_lanes(len(channels), self.sharded.channel_size if self.sharded else 1)
        stacked = channel_stack([per_channel[ch][5] for ch in channels], lanes, n_stack)
        t_dev = time.perf_counter()
        if self.sharded is not None:
            masks = self.sharded.verify_channels(*stacked)
        else:
            dev = self._prep.device
            # (channels, 20, lanes) -> (20, channels * lanes): the channels end to end
            args = [torch.from_numpy(np.ascontiguousarray(
                a.transpose(1, 0, 2).reshape(NLIMBS, -1))).to(dev) for a in stacked[:5]]
            args.append(torch.from_numpy(stacked[5].reshape(-1)).to(dev))
            masks = pk.verify_batch(*args).cpu().numpy().reshape(len(channels), lanes)
        self.last_device_ms = (time.perf_counter() - t_dev) * 1e3

        out: Dict[str, ValidationFlags] = {}
        for c, ch in enumerate(channels):
            t0 = time.perf_counter()
            validator, block, parsed, jobs, job_identity, limbs = per_channel[ch]
            # one host copy of the masks, sliced per channel
            ok_list = masks[c, :limbs[-1].shape[0]].tolist()
            sig_results = validator.finish_sig_results(jobs, job_identity, ok_list)
            # where this channel's signatures ran: the shared launch
            validator.last_sig_backend = self._prep.describe_backend()
            out[ch] = validator.validate(block, parsed, sig_results=sig_results)
            split[ch]["epilogue"] = (time.perf_counter() - t0) * 1e3
        self.last_split_ms = split
        return out
