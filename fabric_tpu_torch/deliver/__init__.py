"""Block delivery (reference common/deliver and core/deliverservice): the
deliver engine that serves seek ranges and the client that pulls them; the
port's counterpart of the JAX package's `deliver` package."""
