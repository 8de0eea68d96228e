"""Batched serving engine of the port (reference: ``repro/serving``)."""
