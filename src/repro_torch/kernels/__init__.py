"""Hand-written CUDA kernels for the server's streaming reductions.

Each kernel module holds the ctypes wrapper of one ``csrc/*.cu`` kernel;
``ref`` holds their plain PyTorch versions and ``ops`` picks between the
two by the device of the tensor it is given.
"""
