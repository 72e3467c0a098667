"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers
and plain PyTorch versions, and the codec entry points over them (``ops``).
Importing this package builds nothing."""
