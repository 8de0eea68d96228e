"""Serving-tree freezing (reference: ``repro/parallel``)."""
