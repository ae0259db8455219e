"""ACL management (reference core/aclmgmt: resources.go, aclmgmtimpl.go,
defaultaclprovider.go).

The port's counterpart of the JAX package's `peer/aclmgmt.py`, over the
port's policy manager (`policy/manager.py`), whose signature policies verify
in batches through the provider (K2 on the card).

Maps resource names ("qscc/GetChainInfo", "peer/Propose", ...) to channel
policy references and evaluates the caller's SignedData against them.
Channel config may override any mapping via the Application group's ACLs
value (peer/configure.go, channelconfig ApplicationConfig.acls); otherwise
the defaults below apply (defaultaclprovider.go:43-112).

One departure, as in the policy manager: a local-MSP check that raises
anything but a `PolicyError` is not turned into an access denial (the JAX
provider wraps every exception of `local_check` in ACLError); it propagates,
so a failing device never reads as "access denied".
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

from fabric_tpu_torch.policy.manager import (
    CHANNEL_APPLICATION_ADMINS,
    CHANNEL_APPLICATION_READERS,
    CHANNEL_APPLICATION_WRITERS,
    Manager,
    PolicyError,
    SignedData,
)

# Resource names (reference core/aclmgmt/resources/resources.go)
LSCC_GET_CHAINCODES = "lscc/GetInstantiatedChaincodes"
LSCC_GET_CC_DATA = "lscc/ChaincodeData"
QSCC_GET_CHAIN_INFO = "qscc/GetChainInfo"
QSCC_GET_BLOCK_BY_NUMBER = "qscc/GetBlockByNumber"
QSCC_GET_BLOCK_BY_HASH = "qscc/GetBlockByHash"
QSCC_GET_TX_BY_ID = "qscc/GetTransactionByID"
QSCC_GET_BLOCK_BY_TX_ID = "qscc/GetBlockByTxID"
CSCC_JOIN_CHAIN = "cscc/JoinChain"
CSCC_GET_CHANNELS = "cscc/GetChannels"
CSCC_GET_CONFIG_BLOCK = "cscc/GetConfigBlock"
PEER_PROPOSE = "peer/Propose"
PEER_CHAINCODE_TO_CHAINCODE = "peer/ChaincodeToChaincode"
EVENT_BLOCK = "event/Block"
EVENT_FILTERED_BLOCK = "event/FilteredBlock"
LIFECYCLE_INSTALL = "_lifecycle/InstallChaincode"
LIFECYCLE_QUERY_INSTALLED = "_lifecycle/QueryInstalledChaincodes"
LIFECYCLE_APPROVE = "_lifecycle/ApproveChaincodeDefinitionForMyOrg"
LIFECYCLE_COMMIT = "_lifecycle/CommitChaincodeDefinition"
LIFECYCLE_CHECK_READINESS = "_lifecycle/CheckCommitReadiness"
LIFECYCLE_QUERY_DEFINITION = "_lifecycle/QueryChaincodeDefinition"

# "local" MSP policies for channel-less resources (defaultaclprovider.go
# pResourcePolicyMap): evaluated against the local MSP, not a channel.
LOCAL_ADMINS = "Admins"
LOCAL_MEMBERS = "Members"

DEFAULT_ACLS: Dict[str, str] = {
    LSCC_GET_CHAINCODES: CHANNEL_APPLICATION_READERS,
    LSCC_GET_CC_DATA: CHANNEL_APPLICATION_READERS,
    QSCC_GET_CHAIN_INFO: CHANNEL_APPLICATION_READERS,
    QSCC_GET_BLOCK_BY_NUMBER: CHANNEL_APPLICATION_READERS,
    QSCC_GET_BLOCK_BY_HASH: CHANNEL_APPLICATION_READERS,
    QSCC_GET_TX_BY_ID: CHANNEL_APPLICATION_READERS,
    QSCC_GET_BLOCK_BY_TX_ID: CHANNEL_APPLICATION_READERS,
    CSCC_GET_CONFIG_BLOCK: CHANNEL_APPLICATION_READERS,
    CSCC_GET_CHANNELS: LOCAL_MEMBERS,
    CSCC_JOIN_CHAIN: LOCAL_ADMINS,
    PEER_PROPOSE: CHANNEL_APPLICATION_WRITERS,
    PEER_CHAINCODE_TO_CHAINCODE: CHANNEL_APPLICATION_WRITERS,
    EVENT_BLOCK: CHANNEL_APPLICATION_READERS,
    EVENT_FILTERED_BLOCK: CHANNEL_APPLICATION_READERS,
    LIFECYCLE_INSTALL: LOCAL_ADMINS,
    LIFECYCLE_QUERY_INSTALLED: LOCAL_ADMINS,
    LIFECYCLE_APPROVE: CHANNEL_APPLICATION_ADMINS,
    LIFECYCLE_COMMIT: CHANNEL_APPLICATION_WRITERS,
    LIFECYCLE_CHECK_READINESS: CHANNEL_APPLICATION_WRITERS,
    LIFECYCLE_QUERY_DEFINITION: CHANNEL_APPLICATION_WRITERS,
}


class ACLError(Exception):
    pass


class ACLProvider:
    """resource -> policy evaluation (aclmgmtimpl.go CheckACL).

    ``get_policy_manager(channel_id)`` resolves the channel's root policy
    manager; ``acl_overrides(channel_id)`` the Application ACLs map from
    channel config (may be empty). ``local_check(policy, signed_data)``
    handles the channel-less local-MSP policies.
    """

    def __init__(
        self,
        get_policy_manager: Callable[[str], Optional[Manager]],
        acl_overrides: Optional[Callable[[str], Dict[str, str]]] = None,
        local_check: Optional[
            Callable[[str, Sequence[SignedData]], None]
        ] = None,
    ):
        self._get_pm = get_policy_manager
        self._overrides = acl_overrides or (lambda cid: {})
        self._local_check = local_check

    def policy_for(self, resource: str, channel_id: str) -> Optional[str]:
        override = self._overrides(channel_id).get(resource)
        if override:
            # config ACLs name Application-relative refs like
            # "/Channel/Application/Readers" or bare sub-policy names
            if not override.startswith("/"):
                override = f"/Channel/Application/{override}"
            return override
        return DEFAULT_ACLS.get(resource)

    def check_acl(
        self,
        resource: str,
        channel_id: str,
        signed_data: Sequence[SignedData],
    ) -> None:
        """Raise ACLError unless signed_data satisfies the resource's
        policy on the channel."""
        policy_name = self.policy_for(resource, channel_id)
        if policy_name is None:
            raise ACLError(f"no policy mapping for resource {resource}")
        if not policy_name.startswith("/"):
            # local MSP policy (channel-less resource)
            if self._local_check is None:
                raise ACLError(
                    f"resource {resource} needs a local MSP check"
                )
            try:
                self._local_check(policy_name, signed_data)
            except PolicyError as e:
                raise ACLError(
                    f"access denied for {resource}: {e}"
                ) from e
            return
        pm = self._get_pm(channel_id)
        if pm is None:
            raise ACLError(f"channel {channel_id} not found")
        policy, ok = pm.get_policy(policy_name)
        if not ok:
            raise ACLError(
                f"policy {policy_name} not found on channel {channel_id}"
            )
        try:
            policy.evaluate_signed_data(signed_data)
        except PolicyError as e:
            raise ACLError(
                f"access denied for {resource} on {channel_id}: {e}"
            ) from e
