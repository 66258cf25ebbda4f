"""The DCGAN example (port of ``examples/dcgan``)."""
