"""Hand-written CUDA kernels of the port, their wrappers and plain
versions (``ref.py`` for the BLSTM, beside the wrapper elsewhere) and the
``nvcc``/ctypes loader (``build.py``)."""
