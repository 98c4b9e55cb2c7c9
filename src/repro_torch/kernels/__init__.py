"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``ops`` holds the public wrappers; ``ref`` the plain versions; one module
per kernel (``peel_wave``, ``bitmap_support``) binds the CUDA source in
``../csrc`` that ``_build`` compiles with ``nvcc`` at first use.
"""
