"""The readers of the program's spans (``harness/spans.py`` and the metric
files over it): None where the port has no recorder or the recorder holds
no such span, and the right value from a recorder filled by hand."""

import sys
import types

import pytest

from phendiff_tpu_torch.obs import profiling
from portbench.harness import spans, spec

READERS = {
    "denoise_host_ms.transfer": "transfer/denoise",
    "denoise_latency_ms.transfer": "transfer/denoise",
    "step_host_ms.train": "train/step",
    "step_host_ms.finetune": "train/step",
    "optimizer_host_ms.train": "train/step",
    "optimizer_host_ms.finetune": "train/step",
    "step_latency_ms.train": "train/step",
    "step_latency_ms.finetune": "train/step",
}


def _span(name, start_ms, end_ms, lead_ms=None):
    """A closed span; ``lead_ms``: the device finished its queued work
    that long after its close."""
    s = profiling.Span(name)
    s.start_ns, s.end_ns = int(start_ms * 1e6), int(end_ms * 1e6)
    if lead_ms is not None:
        s._done_ns = s.end_ns + int(lead_ms * 1e6)
    return s


@pytest.fixture
def filled(monkeypatch):
    """Three train steps (40, 50, 60 ms; optimizer 10 + EMA 2 ms each,
    leads 3, 9, 5 ms) and four denoiser calls (5, 6, 7, 10 ms; leads 20,
    30, 40, 50 ms), with other spans beside them."""
    rec = profiling.Recorder()
    at = 0.0
    for length, lead in ((40, 3), (50, 9), (60, 5)):
        rec.add(_span("train/forward", at, at + 5))
        rec.add(_span("train/optimizer", at + 20, at + 30))
        rec.add(_span("train/ema", at + 30, at + 32))
        rec.add(_span("train/step", at, at + length, lead))
        at += 100
    for length, lead in ((5, 20), (6, 30), (7, 40), (10, 50)):
        rec.add(_span("transfer/denoise", at, at + length, lead))
        at += 20
    rec.add(_span("engine/transfer", 300, at))
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    return rec


def _read(name):
    return spec.metric_reader(name).read({"stretch": None, "window_s": 1.0})


def test_every_new_metric_has_its_reader_and_its_entry():
    bench = {m["name"]: m for m in spec.load_json(spec.ROOT / "BENCHMARK.json")["per_layer"]}
    for name in READERS:
        assert name in bench and callable(spec.metric_reader(name).read)
        assert bench[name]["unit"] == "ms" and bench[name]["better"] == "lower"
        assert bench[name]["source"] == "program_span"


def test_readers_read_a_recorder_filled_by_hand(filled):
    want = {
        "denoise_host_ms.transfer": 7.0,
        "denoise_latency_ms.transfer": 41.5,  # 25, 36, 47, 60
        "step_host_ms.train": 50.0,
        "step_host_ms.finetune": 50.0,
        "optimizer_host_ms.train": 12.0,
        "optimizer_host_ms.finetune": 12.0,
        "step_latency_ms.train": 59.0,  # 43, 59, 65
        "step_latency_ms.finetune": 59.0,
    }
    for name, value in want.items():
        assert _read(name) == pytest.approx(value), name


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_give_none_without_such_spans(name, monkeypatch):
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    assert _read(name) is None
    other = "train/step" if READERS[name] == "transfer/denoise" else "transfer/denoise"
    rec.add(_span(other, 0, 10, lead_ms=1))
    assert _read(name) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_give_none_without_a_recorder(name, monkeypatch):
    """As on a port with no recorder: ``profiling`` without ``recorder``,
    or no port at all."""
    bare = types.ModuleType("phendiff_tpu_torch.obs.profiling")
    monkeypatch.setitem(sys.modules, "phendiff_tpu_torch.obs.profiling", bare)
    monkeypatch.setattr(sys.modules["phendiff_tpu_torch.obs"], "profiling", bare)
    assert _read(name) is None
    monkeypatch.setitem(sys.modules, "phendiff_tpu_torch.obs.profiling", None)
    monkeypatch.delattr(sys.modules["phendiff_tpu_torch.obs"], "profiling")
    assert spans._recorder() is None and _read(name) is None
