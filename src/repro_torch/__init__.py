"""PyTorch/CUDA port of the truss engine in ``repro``.

The package mirrors ``repro`` module for module (``repro_torch/core/peel.py``
is the port of ``repro/core/peel.py``) and imports nothing from it, nor JAX:
the jax-free modules it needs are kept here as copies under the same
relative path.  The adjacency-bitmap Pallas kernels are hand-written CUDA
(``csrc/bitmap_popcount.cu``), built with ``nvcc`` at first use.

Entry points (``core.DynamicGraph``, ``core.decompose``, ``core.peel``, the
state constructors) take ``device=`` and default to ``"cuda"``; everything
below them runs on the device of the tensors it is given.
"""
