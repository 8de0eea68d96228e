"""PyTorch / CUDA port of the Siracusa reproduction (reference: ``repro``).

The layout mirrors ``src/repro/`` module for module.  The package imports
``torch``, ``numpy`` and the standard library only, never ``jax`` or
``repro``.  Hand-written Hopper kernels live in ``csrc/`` and are bound
through ``kernels/``.
"""
