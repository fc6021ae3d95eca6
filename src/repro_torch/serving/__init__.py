"""Serving stack of the port: the wgkv Engine, paged pool, orchestrator."""
