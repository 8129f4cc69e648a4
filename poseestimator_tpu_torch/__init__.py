"""poseestimator_tpu_torch: the PyTorch / CUDA port of poseestimator_tpu.

The per-frame detect + track program of the JAX package, written in PyTorch
for an NVIDIA H100, with the JAX package's two Pallas TPU kernels rewritten
by hand in CUDA C++ for Hopper (``csrc/``): the fused nearest neighbour (K1,
``geom3d/fused_nn.py``) and the triangle z-buffer (K2, ``render/raster.py``).
Each kernel has a plain PyTorch version beside it, which CPU tensors take.
The JAX package is the reference; this package imports nothing of it.
"""

__version__ = "0.1.0"
