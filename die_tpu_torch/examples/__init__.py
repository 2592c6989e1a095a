"""The JAX package's example scripts on the port.  Each runs by ``python3
-m die_tpu_torch.examples.<name>`` with the script's arguments plus
``--device`` (``cuda`` unless ``cpu`` is asked for) and does nothing when
imported."""
