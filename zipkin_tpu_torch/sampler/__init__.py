"""Sampling: vectorized trace-id sampler + adaptive rate controller.

Reference parity: zipkin-sampler (Sampler.scala:27, SpanSamplerFilter.scala:30,
AdaptiveSampler.scala:59-71) the port's copy of ``zipkin_tpu/sampler``: the threshold test runs
vectorized on torch tensors (or on the parsed numpy columns of the
native fast path), and the control loop is a single-controller pure-function pipeline fed by
globally psum-able device counters — no ZooKeeper.
"""

from zipkin_tpu_torch.sampler.core import (  # noqa: F401
    Sampler,
    rate_to_threshold,
    sample_mask,
)
from zipkin_tpu_torch.sampler.adaptive import (  # noqa: F401
    AdaptiveConfig,
    AdaptiveSampleRateController,
    calculate_sample_rate,
    cooldown_check,
    discounted_average,
    outlier_check,
    request_rate_check,
    sufficient_data_check,
    valid_data_check,
)
