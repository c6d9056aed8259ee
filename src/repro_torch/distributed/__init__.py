"""Distributed-optimization pieces of the port (one device so far)."""
