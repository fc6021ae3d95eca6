"""Core WG-KV math of the port: write gate, dual cache, page metadata."""
