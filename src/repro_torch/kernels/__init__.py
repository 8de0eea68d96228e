"""Hopper kernels of the port, their plain PyTorch versions and the
wrappers that dispatch between them (reference: ``repro/kernels``)."""
