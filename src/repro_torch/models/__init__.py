"""Model code of the port (reference: ``repro/models``)."""
