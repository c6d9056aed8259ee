"""Data layer of the port: synthetic LM data and the epoch sampler."""
