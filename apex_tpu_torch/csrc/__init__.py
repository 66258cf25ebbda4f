"""Hand-written CUDA C++ kernels of the port (built by ``build.py``)."""
