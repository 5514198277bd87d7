"""Hand-written CUDA kernels of the port, their wrappers, plain versions
(``ref.py``) and the ``nvcc``/ctypes loader (``build.py``)."""
