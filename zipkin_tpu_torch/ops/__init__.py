"""Device primitives: hashing, sketches, moments, join, and the
hand-written CUDA kernels (ops/kernels.py, csrc/).

The sketches (count-min, HyperLogLog, log-histogram quantiles, top-k
counters) and the moments helpers have the APIs of ``zipkin_tpu.ops``;
each takes a ``device`` where it makes state, the card by default.
"""

from zipkin_tpu_torch.ops import cms, hashing, hll, moments, quantile, topk  # noqa: F401
