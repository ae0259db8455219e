"""Gossip (reference gossip/): the message store, membership and leader
election, state transfer, the pull rounds, private-data dissemination and
reconciliation, the commit coordinator and the gRPC gossip node; the port's
counterpart of the JAX package's `gossip` package. Only `gossip.comm`
imports grpc, and no module of the package imports torch."""
