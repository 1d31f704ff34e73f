"""Measurement scripts for the port (run with ``python -m``)."""
