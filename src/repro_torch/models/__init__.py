"""Dense decoder LM of the port (counterpart of ``repro.models``)."""
