"""Distributed pieces of the port: int8 compression, host collectives,
the score store's device layout, and fault tolerance."""
