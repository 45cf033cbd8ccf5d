"""Runnable examples of the port: ``python -m repro_torch.examples.<name>
--device cpu|cuda`` (the JAX package's ``examples/`` on the port)."""
