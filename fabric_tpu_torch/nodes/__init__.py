"""The node composition roots (reference usable-inter-nal/peer/node,
orderer/common/server): the port's counterpart of the JAX package's
`nodes` package."""
