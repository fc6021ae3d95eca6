"""Synthetic data of the port (port of ``repro/data``)."""
