"""Device primitives: hashing, sketches, moments, join, and the
hand-written CUDA kernels (ops/kernels.py, csrc/)."""
