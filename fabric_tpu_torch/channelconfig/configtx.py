"""Config transaction validation (reference common/configtx/validator.go,
update.go).

The port's counterpart of the JAX package's `channelconfig/configtx.py`, over
the wire codec (configs, updates and envelopes are dicts in `wire.decode`'s
form, `protos/configtx.py`). A ConfigUpdate names a read set (elements
whose versions must match the current config) and a write set (the new
state). The delta = write-set elements whose version advanced; each delta
element must advance by exactly one and be authorized by the MOD_POLICY of
the existing element (for new elements: the enclosing group's mod policy),
evaluated over the ConfigSignatures, whose signatures the policy tree
verifies in batches through its provider. The result is the current config
with the write set merged and sequence+1. `validate` compares the recomputed
channel group with the proposed one in `wire.encode`'s bytes, which are
protobuf's deterministic serialization.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from fabric_tpu_torch.policy.manager import Manager, PolicyError, SignedData
from fabric_tpu_torch.protos import configtx as cfgpb
from fabric_tpu_torch.protos import fabric, protoutil, wire


class ConfigTxError(Exception):
    pass


# ---------------------------------------------------------------------------
# Flatten the config tree into path-keyed elements (update.go works on
# "scoped values"; paths here are ("groups", name, ...) tuples).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Elem:
    kind: str  # "group" | "value" | "policy"
    path: Tuple[str, ...]  # group path from root (excluding the root)
    name: str  # "" for the group itself
    version: int
    mod_policy: str
    data: bytes  # serialized payload for equality checks


def _flatten(group: dict, path: Tuple[str, ...] = ()) -> Dict:
    out: Dict[Tuple[str, str, Tuple[str, ...]], _Elem] = {}
    out[("group", "", path)] = _Elem(
        "group", path, "", group.get("version", 0), group.get("mod_policy", ""), b""
    )
    for name, cv in group.get("values", {}).items():
        out[("value", name, path)] = _Elem(
            "value", path, name, cv.get("version", 0), cv.get("mod_policy", ""),
            cv.get("value", b"")
        )
    for name, cp in group.get("policies", {}).items():
        out[("policy", name, path)] = _Elem(
            "policy", path, name, cp.get("version", 0), cp.get("mod_policy", ""),
            wire.encode(cfgpb.POLICY, cp.get("policy", {}))
        )
    for name, sub in group.get("groups", {}).items():
        out.update(_flatten(sub, path + (name,)))
    return out


def _group_at(root: dict, path: Tuple[str, ...]) -> Optional[dict]:
    g = root
    for seg in path:
        if seg not in g.get("groups", {}):
            return None
        g = g["groups"][seg]
    return g


def _resolve_mod_policy(mod_policy: str, path: Tuple[str, ...]) -> str:
    """Relative mod policies resolve against the element's group path
    (reference policies/util.go / validator relativity rules)."""
    if not mod_policy:
        return ""
    if mod_policy.startswith("/"):
        return mod_policy
    return "/" + "/".join(("Channel",) + path + (mod_policy,))


def _key_path(key) -> str:
    return "/".join(key[2] + (key[1],))


class Validator:
    """Per-channel config state machine (reference configtx.ValidatorImpl)."""

    def __init__(self, channel_id: str, config: dict, policy_manager: Optional[Manager] = None):
        if "channel_group" not in config:
            raise ConfigTxError("config did not contain a channel group")
        self.channel_id = channel_id
        self.config = config
        self.policy_manager = policy_manager

    @property
    def sequence(self) -> int:
        return self.config.get("sequence", 0)

    def propose_config_update(self, update_env: dict) -> dict:
        """CONFIG_UPDATE envelope -> the resulting ConfigEnvelope, or raise."""
        payload = protoutil.unmarshal(fabric.PAYLOAD, update_env.get("payload", b""))
        cue = protoutil.unmarshal(cfgpb.CONFIG_UPDATE_ENVELOPE, payload.get("data", b""))
        return self.propose_config_update_envelope(cue, last_update=update_env)

    def propose_config_update_envelope(self, cue: dict, last_update: Optional[dict] = None) -> dict:
        update = protoutil.unmarshal(cfgpb.CONFIG_UPDATE, cue.get("config_update", b""))
        channel_id = update.get("channel_id", "")
        if channel_id != self.channel_id:
            raise ConfigTxError(
                f"update is for channel {channel_id!r}, not {self.channel_id!r}"
            )

        current = _flatten(self.config["channel_group"])
        read_set = _flatten(update.get("read_set", {}))
        write_set = _flatten(update.get("write_set", {}))

        # 1. verify read set versions (update.go verifyReadSet)
        for key, elem in read_set.items():
            cur = current.get(key)
            if cur is None:
                raise ConfigTxError(
                    f"existing config does not contain element for "
                    f"{key[0]} {_key_path(key)} but was in the read set"
                )
            if cur.version != elem.version:
                raise ConfigTxError(
                    f"readset expected key {_key_path(key)} at "
                    f"version {elem.version}, but got version {cur.version}"
                )

        # 2. compute the delta set (update.go computeDeltaSet)
        delta: Dict[Tuple[str, str, Tuple[str, ...]], _Elem] = {}
        for key, elem in write_set.items():
            read = read_set.get(key)
            if read is not None and read.version == elem.version:
                continue  # unmodified carry-over
            delta[key] = elem

        # 3. verify the delta set + authorize (update.go verifyDeltaSet)
        signed_data = []
        for s in cue.get("signatures", ()):
            data, creator = _config_update_signed_data(cue, s)
            signed_data.append(SignedData(data, creator, s.get("signature", b"")))
        for key, elem in delta.items():
            cur = current.get(key)
            expected = (cur.version + 1) if cur is not None else 0
            if elem.version != expected:
                raise ConfigTxError(
                    f"attempt to set key {_key_path(key)} to "
                    f"version {elem.version}, but key is at version "
                    f"{cur.version if cur else '<absent>'}"
                )
            mod_policy = (
                cur.mod_policy
                if cur is not None
                else self._new_item_mod_policy(key, write_set, current)
            )
            self._authorize(mod_policy, key, signed_data)

        # 4. apply: overlay ONLY the delta onto the current config (reference
        # computeUpdateResult, update.go:192-203: same-version write-set
        # content is discarded, keeping current bytes, so tampered
        # unmodified-version elements cannot bypass authorization).
        new_group = _merge_delta(
            self.config["channel_group"], update.get("write_set"), delta, ()
        )
        out = {"config": {"sequence": self.sequence + 1, "channel_group": new_group}}
        if last_update is not None:
            out["last_update"] = copy.deepcopy(last_update)
        return out

    def validate(self, config_env: dict) -> None:
        """Validate a proposed full config against the current one
        (reference Validator.Validate): recompute from last_update and
        require equality."""
        config = config_env.get("config", {})
        if config.get("sequence", 0) != self.sequence + 1:
            raise ConfigTxError(
                f"config currently at sequence {self.sequence}, cannot "
                f"validate config at sequence {config.get('sequence', 0)}"
            )
        if "last_update" in config_env:
            computed = self.propose_config_update(config_env["last_update"])
            if (wire.encode(cfgpb.CONFIG_GROUP, computed["config"]["channel_group"])
                    != wire.encode(cfgpb.CONFIG_GROUP, config.get("channel_group", {}))):
                raise ConfigTxError("config proposed does not match calculated config")

    def apply(self, config_env: dict) -> None:
        self.validate(config_env)
        self.config = copy.deepcopy(config_env.get("config", {}))

    # -- helpers -----------------------------------------------------------

    def _new_item_mod_policy(self, key, write_set, current) -> str:
        """New elements are governed by the nearest existing ancestor
        group's mod policy (reference update.go verifyDeltaSet uses the
        group's mod_policy for adds)."""
        path = key[2]
        while True:
            cur = current.get(("group", "", path))
            if cur is not None:
                return cur.mod_policy
            if not path:
                return ""
            path = path[:-1]

    def _authorize(self, mod_policy: str, key, signed_data) -> None:
        if self.policy_manager is None:
            return  # unauthenticated mode (tests / local tooling)
        if not mod_policy:
            raise ConfigTxError(f"key {_key_path(key)} has no mod policy; cannot modify")
        resolved = _resolve_mod_policy(mod_policy, key[2])
        policy, ok = self.policy_manager.get_policy(resolved)
        if not ok:
            raise ConfigTxError(f"mod policy {resolved} not found")
        try:
            policy.evaluate_signed_data(signed_data)
        except PolicyError as e:
            raise ConfigTxError(
                f"config update is not authorized by mod policy {resolved}: {e}"
            ) from e


def _config_update_signed_data(cue: dict, sig: dict) -> Tuple[bytes, bytes]:
    """Signed bytes = signature_header || config_update (reference
    ConfigUpdateEnvelope.AsSignedData, protoutil/signeddata.go:35-53);
    returns (data, creator identity bytes)."""
    header = sig.get("signature_header", b"")
    sh = protoutil.unmarshal(fabric.SIGNATURE_HEADER, header)
    return header + cue.get("config_update", b""), sh.get("creator", b"")


def sign_config_update(cue: dict, signer) -> None:
    """Append one ConfigSignature by a `msp.signer.SigningIdentity` (its
    `serialize`, `sign` and `new_nonce`, a seeded nonce)."""
    header = wire.encode(fabric.SIGNATURE_HEADER,
                         {"creator": signer.serialize(), "nonce": signer.new_nonce()})
    cue.setdefault("signatures", []).append(
        {"signature_header": header,
         "signature": signer.sign(header + cue.get("config_update", b""))})


def _merge_delta(current: Optional[dict], write: Optional[dict], delta: Dict,
                 path: Tuple[str, ...]) -> dict:
    """Current tree with delta elements overlaid. Content for non-delta
    elements always comes from CURRENT (never the write set). Group
    membership follows the write set only when the group itself is in the
    delta (a version bump authorizes adds/removes); otherwise membership
    is current plus any new delta children."""
    out: dict = {}
    group_in_delta = ("group", "", path) in delta
    meta_src = write if (group_in_delta and write is not None) else current
    if meta_src is not None:
        out["version"] = meta_src.get("version", 0)
        out["mod_policy"] = meta_src.get("mod_policy", "")

    cur_values = current.get("values", {}) if current is not None else {}
    cur_policies = current.get("policies", {}) if current is not None else {}
    cur_groups = current.get("groups", {}) if current is not None else {}
    wr_values = write.get("values", {}) if write is not None else {}
    wr_policies = write.get("policies", {}) if write is not None else {}
    wr_groups = write.get("groups", {}) if write is not None else {}

    if group_in_delta:
        value_names = set(wr_values)
        policy_names = set(wr_policies)
        group_names = set(wr_groups)
    else:
        value_names = set(cur_values) | {n for n in wr_values if ("value", n, path) in delta}
        policy_names = set(cur_policies) | {n for n in wr_policies if ("policy", n, path) in delta}
        group_names = set(cur_groups) | {
            n for n in wr_groups if _subtree_has_delta(delta, path + (n,))
        }

    values, policies, groups = {}, {}, {}
    for name in value_names:
        src = wr_values[name] if ("value", name, path) in delta else cur_values.get(name)
        if src is not None:
            values[name] = copy.deepcopy(src)
    for name in policy_names:
        src = wr_policies[name] if ("policy", name, path) in delta else cur_policies.get(name)
        if src is not None:
            policies[name] = copy.deepcopy(src)
    for name in group_names:
        sub_path = path + (name,)
        if _subtree_has_delta(delta, sub_path):
            groups[name] = _merge_delta(cur_groups.get(name), wr_groups.get(name), delta, sub_path)
        elif name in cur_groups:
            groups[name] = copy.deepcopy(cur_groups[name])
    for key, entries in (("groups", groups), ("values", values), ("policies", policies)):
        if entries:
            out[key] = entries
    return out


def _subtree_has_delta(delta: Dict, path: Tuple[str, ...]) -> bool:
    return any(key[2][: len(path)] == path for key in delta)
