"""WAL-shipped replication: warm standbys + device-free read replicas.

The production shape for "millions of concurrent viewers"
(docs/REPLICATION.md): one chip owns the write path, sealed WAL
records stream to followers over the framed-TCP wire layer, and
followers run as either

- a **warm standby** — a full device store replaying through the
  normal commit body (the primary's state at every applied sequence:
  bitwise, except the three float32 moment leaves on the card, which
  agree within stated tolerance 2 of ``testing/crash.py``), or
- a **device-free replica** (store/replica.py) — SketchMirror +
  cold-tier segments on plain CPUs, serving the whole sketch tier and
  zone-map-pruned row queries behind the unchanged SpanStore SPI.

The port's copy of ``zipkin_tpu/replicate``. A standby's store lives on
the card (CUDA) unless its caller asks for the CPU, and replays every
shipped record through the same commit body, and so the same CUDA
kernels, as the primary's writes; the replica is host-only by design
(no device anywhere), not a fallback. Frames, records and anchors are
the reference's bytes, so either package's followers follow either
package's primary.

Pieces: ``protocol`` (frames), ``ship`` (primary-side shipper +
server, retention-pinned in the WAL), ``follow`` (the fetch-apply
loop + targets).
"""

from zipkin_tpu_torch.replicate.follow import (  # noqa: F401
    Follower,
    ReplicaTarget,
    ShipClient,
    StandbyTarget,
)
from zipkin_tpu_torch.replicate.protocol import ShipProtocolError  # noqa: F401
from zipkin_tpu_torch.replicate.ship import ShipServer, WalShipper  # noqa: F401

__all__ = [
    "Follower",
    "ReplicaTarget",
    "ShipClient",
    "ShipProtocolError",
    "ShipServer",
    "StandbyTarget",
    "WalShipper",
]
