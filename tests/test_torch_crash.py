"""The port's crash-injection matrix on the CPU: a child process
(``python -m zipkin_tpu_torch.testing.crash --device cpu``) drives a
``TorchSpanStore`` with a WAL attached and SIGKILLs itself at a named
point; the parent recovers from what is on disk and requires

- every durably acked batch to survive,
- the recovered state to equal, bitwise, an uncrashed drive of exactly
  the recovered prefix,
- the first unapplied batch to be absent, never partial.

The after-append smoke and a tiered drive (eviction capture on its
replayed path) run in the fast lane; the rest of the matrix is marked
slow, as in ``tests/test_crash.py``. ``mid-seal`` kills a tiered drive
between a capture pull and the cold segment append: recovery must keep
the acked prefix and seal the oracle's cold segments, the sealed
frontier contiguous up to the capture clock.
"""

import signal

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from zipkin_tpu_torch.testing import crash  # noqa: E402
from zipkin_tpu_torch.testing.crash import (  # noqa: E402
    acked_batches,
    run_crash_child,
    verify_recovery,
)

SIGKILLED = -signal.SIGKILL


def _crash_and_verify(tmp_path, point, hit, batches, ckpt_at=(),
                      segment_bytes=64 << 20, tiered=False):
    wd = str(tmp_path)
    proc = run_crash_child(wd, point=point, hit=hit, batches=batches,
                           ckpt_at=ckpt_at, segment_bytes=segment_bytes,
                           tiered=tiered, device="cpu", timeout=300)
    assert proc.returncode == SIGKILLED, (
        f"child survived {point}:{hit} (rc {proc.returncode})\n"
        f"{proc.stderr[-2000:]}")
    return verify_recovery(wd, total_batches=batches, tiered=tiered,
                           device="cpu")


def test_port_crash_after_append_recovers_exactly(tmp_path):
    """The record is durable, the commit never ran; a checkpoint covers
    part of the log, so recovery is restore + truncated-prefix replay."""
    info = _crash_and_verify(tmp_path, "after-append", hit=4, batches=6,
                             ckpt_at=(2,))
    assert info["applied"] == 4
    assert info["acked"] == 3


def test_port_tiered_drive_waits_for_the_cold_tier(tmp_path):
    """A clean tiered child (its 2^8 ring laps, so captures seal on the
    way) recovers from its checkpoint and log to the uncrashed drive:
    state bitwise, the same cold segments, the sealed frontier at the
    capture clock."""
    assert crash.crash_config(tiered=True).capacity == 1 << 8
    proc = run_crash_child(str(tmp_path), point=None, batches=12,
                           ckpt_at=(6,), tiered=True, device="cpu",
                           timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    info = verify_recovery(str(tmp_path), total_batches=12, tiered=True,
                           device="cpu")
    assert info["applied"] == info["acked"] == 12
    assert info["replayed_records"] == 6


@pytest.mark.slow
def test_port_crash_before_append(tmp_path):
    info = _crash_and_verify(tmp_path, "before-append", hit=5, batches=8,
                             ckpt_at=(3,))
    assert info["applied"] == info["acked"] == 4


@pytest.mark.slow
def test_port_crash_after_commit(tmp_path):
    info = _crash_and_verify(tmp_path, "after-commit", hit=5, batches=8,
                             ckpt_at=(3,))
    assert info["applied"] == 5
    assert info["acked"] == 4


@pytest.mark.slow
def test_port_crash_mid_first_checkpoint(tmp_path):
    info = _crash_and_verify(tmp_path, "mid-checkpoint", hit=1, batches=8,
                             ckpt_at=(5,))
    assert info["applied"] == info["acked"] == 5


@pytest.mark.slow
def test_port_crash_mid_second_checkpoint(tmp_path):
    info = _crash_and_verify(tmp_path, "mid-checkpoint", hit=2,
                             batches=10, ckpt_at=(4, 8))
    assert info["applied"] == info["acked"] == 8


@pytest.mark.slow
def test_port_crash_mid_truncate(tmp_path):
    info = _crash_and_verify(tmp_path, "mid-truncate", hit=2, batches=8,
                             ckpt_at=(6,), segment_bytes=1 << 12)
    assert info["applied"] == info["acked"] == 6


@pytest.mark.slow
def test_port_crash_mid_seal_replays_capture(tmp_path):
    info = _crash_and_verify(tmp_path, "mid-seal", hit=2, batches=30,
                             tiered=True)
    assert info["applied"] >= info["acked"]
    assert info["replayed_records"] > 0


@pytest.mark.slow
def test_port_crash_mid_seal_with_checkpoint(tmp_path):
    info = _crash_and_verify(tmp_path, "mid-seal", hit=3, batches=30,
                             ckpt_at=(10,), tiered=True)
    assert info["applied"] >= info["acked"]


@pytest.mark.slow
def test_port_clean_child_exits_zero(tmp_path):
    proc = run_crash_child(str(tmp_path), point=None, batches=4,
                           ckpt_at=(2,), device="cpu", timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert acked_batches(str(tmp_path)) == 4
