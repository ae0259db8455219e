"""The gRPC layer (reference Fabric's pkg/comm): the server and client
plumbing and the service adapters; the port's counterpart of the JAX
package's `comm` package. These modules import grpc."""
