"""Hand-written Hopper kernels of the port, one package per TPU kernel of
``repro.kernels``: ``ref.py`` holds the plain PyTorch version, ``ops.py``
the wrapper (a CPU tensor takes the plain version, a CUDA tensor launches
the kernel or raises) and ``csrc/`` the CUDA C++ source."""
