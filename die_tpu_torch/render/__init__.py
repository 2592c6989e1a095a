"""Host-side rendering of env states (twin of the JAX package's
``render/``): ``renderer.py`` turns a state into numpy images,
``plotting.py`` shows them live or records a GIF."""
