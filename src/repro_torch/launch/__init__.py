"""Step builders and launchers of the port (reference: ``repro/launch``)."""
