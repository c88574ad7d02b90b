"""zipkin-tpu ported to PyTorch and CUDA (NVIDIA Hopper).

A second package beside the JAX reference ``zipkin_tpu``; it imports
nothing of it. See README.md, "PyTorch/CUDA port".
"""
