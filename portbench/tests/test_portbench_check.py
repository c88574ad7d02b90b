"""The check that decides ``correct``: the port against the reference on
the CPU at a tiny size, each fault a run can have, and the control."""

import pytest

from conftest import CELLS, ROOT, tiny
from portbench.control import control_numbers
from portbench.lib.cell import run_cell


def _run(cell, seed=11, seconds=0.6, trace=False):
    cfg, mix = tiny(cell)
    return run_cell(ROOT, cell, seed, seconds, trace, device="cpu",
                    config_override=cfg, mix_override=mix)


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_reference_on_cpu(cell):
    out = _run(cell, seed=2**31 + 12345)
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0
    names = set(out.checks)
    assert {"counts_off", "hll_off", "rows_off", "index_off",
            "dep_count_off", "dep_gap"} <= names
    assert ("window_off" in names) == cell.startswith("window")


def _state_unchanged_once(monkeypatch):
    from zipkin_tpu_torch.store import device as dev

    real, calls = dev.ingest_steps, []

    def step(state, batches):
        calls.append(1)
        if len(calls) == 5:  # a window step
            return state
        return real(state, batches)

    monkeypatch.setattr(dev, "ingest_steps", step)


def _half_batch_once(monkeypatch):
    from zipkin_tpu_torch.store import device as dev

    real, calls = dev.ingest_steps, []

    def step(state, batches):
        calls.append(1)
        if len(calls) == 5:
            batches = [b._replace(n_spans=b.n_spans // 2,
                                  n_anns=b.n_anns // 2,
                                  n_banns=b.n_banns // 2) for b in batches]
        return real(state, batches)

    monkeypatch.setattr(dev, "ingest_steps", step)


def _answer_altered(monkeypatch):
    from zipkin_tpu_torch.store.torch_store import TorchSpanStore

    real = TorchSpanStore.get_trace_ids_by_name

    def ids(self, *a, **kw):
        got = real(self, *a, **kw)
        if got:
            got[0] = type(got[0])(got[0].trace_id ^ 1, got[0].timestamp)
        return got

    monkeypatch.setattr(TorchSpanStore, "get_trace_ids_by_name", ids)


FAULTS = {"state_unchanged": _state_unchanged_once,
          "half_batch": _half_batch_once,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_in_the_timed_path_is_not_correct(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    out = _run(cell)
    assert not out.correct, (fault, out.checks)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    cfg, mix = tiny(cell)
    nums = control_numbers(ROOT, cell, 21, 6, "cpu", config=cfg, mix=mix)
    assert any(c["value"] > c["limit"] for c in nums.values()), nums
