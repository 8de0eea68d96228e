"""Numeric core of the port: packing, quantization, the packed weight
store, placement and the executable weight scenarios (reference:
``repro/core``)."""
