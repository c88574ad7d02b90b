"""Aggregation host math, torch side: the windowed Moments-sketch
arena (``windows``). The dependency job of the JAX package
(``aggregate/job.py``) is not part of the port yet."""
