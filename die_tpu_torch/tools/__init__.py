"""Tools of the port: benches and on-card probes (``probes.py``)."""
