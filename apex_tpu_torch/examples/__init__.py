"""The port's example recipes (``examples/`` of the JAX package), kept under
the package so that the JAX package's lint does not scan them."""
