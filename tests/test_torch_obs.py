"""The port's observability hooks on the CPU: ``WandbTracker`` against a
stub ``wandb`` module (the JAX package's tracker makes the same calls on
it), the JSONL fallback where ``wandb`` cannot be imported, ``trace_if``
writing a profiler trace with the port's spans in it (a train step's among
them), and ``force_sync``;
``image_grid`` and ``latents_to_grayscale`` against the JAX package's.
"""

import glob
import json
import sys
import types

import numpy as np
import torch

import pytest

from phendiff_tpu.obs import images as jax_images
from phendiff_tpu.obs import trackers as jax_trackers
from phendiff_tpu_torch.obs import images, profiling, trackers


def _stub_wandb(calls):
    """A ``wandb`` module recording what a tracker calls on it."""
    mod = types.ModuleType("wandb")

    class Run:
        id = "run-7"

        def log(self, metrics, step=None):
            calls.append(("log", metrics, step))

        def finish(self):
            calls.append(("finish",))

    class Image:
        def __init__(self, arr):
            self.shape = np.asarray(arr).shape

    def init(**kw):
        calls.append(("init", kw))
        return Run()

    def alert(**kw):
        calls.append(("alert", kw))

    mod.init, mod.alert, mod.Image = init, alert, Image
    return mod


def _drive(module, run_dir):
    t = module.make_tracker("wandb", run_dir, project="p", config={"lr": 1e-4})
    t.log({"loss": 0.25}, 3)
    t.log_images("samples/DMSO", np.zeros((2, 4, 4, 3)), 3)
    t.alert("NaN", "at step 3")
    t.finish()
    return t


def test_wandb_tracker_makes_the_jax_trackers_calls(tmp_path, monkeypatch):
    got, want = [], []
    monkeypatch.setitem(sys.modules, "wandb", _stub_wandb(got))
    t = _drive(trackers, str(tmp_path))
    assert isinstance(t, trackers.WandbTracker) and t.run_id == "run-7"
    monkeypatch.setitem(sys.modules, "wandb", _stub_wandb(want))
    _drive(jax_trackers, str(tmp_path))

    def plain(calls):  # images by shape
        return [(c[0], {k: [i.shape for i in v] if isinstance(v, list) else v
                        for k, v in c[1].items()}, *c[2:]) if c[0] == "log" else c
                for c in calls]

    assert plain(got) == plain(want)
    assert got[0] == ("init", {"project": "p", "dir": str(tmp_path), "config": {"lr": 1e-4},
                               "id": None, "resume": None})
    assert [c[0] for c in got] == ["init", "log", "log", "alert", "finish"]


def test_make_tracker_falls_back_to_jsonl_without_wandb(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    t = trackers.make_tracker("wandb", str(tmp_path))
    assert isinstance(t, trackers.JSONLTracker)
    assert isinstance(jax_trackers.make_tracker("wandb", str(tmp_path)),
                      jax_trackers.JSONLTracker)
    t.log({"loss": 1.5}, 1)
    t.finish()
    with open(tmp_path / "metrics.jsonl") as f:
        assert json.loads(f.readline())["loss"] == 1.5


def _linear_train_step():
    """The port's train step over a one-weight model, and its inputs."""
    from phendiff_tpu_torch.core import scheduler as S
    from phendiff_tpu_torch.train import train_loop as T

    cfg = T.TrainConfig()
    opt = T.make_optimizer(cfg.optimizer)
    step = T.make_train_step(lambda p, x, t, ce: x * p["w"] + ce[:, None, None, :],
                             lambda p, labels: p["e"][labels],
                             S.make_schedule(S.SchedulerConfig(num_train_timesteps=10),
                                             device="cpu"), cfg, opt)
    state = T.init_train_state({"w": torch.ones(3, requires_grad=True),
                                "e": torch.zeros(2, 3, requires_grad=True)}, opt)
    batch = (torch.rand(2, 4, 4, 3), torch.tensor([0, 1]))
    return step, state, batch, T.make_draws(0, 0, (2, 4, 4, 3), 10, 0.0, "cpu")


def test_trace_if_writes_a_trace_on_capture_steps_only(tmp_path):
    x = torch.randn(16, 16)
    with profiling.trace_if(str(tmp_path / "off"), step=3, capture_steps=(10,)):
        x @ x
    assert not (tmp_path / "off").exists()
    step, state, batch, draws = _linear_train_step()
    with profiling.trace_if(str(tmp_path / "on"), step=10, capture_steps=(10,)):
        with profiling.annotate("engine/transfer"):
            x @ x
        step(state, batch, draws)
    (trace,) = glob.glob(str(tmp_path / "on" / "*.pt.trace.json"))
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"engine/transfer", "train/step", "train/backward"} <= names
    profiling.recorder().clear()
    with profiling.trace_if(None, step=10, capture_steps=(10,)):
        pass


def test_annotate_is_a_span_in_the_profiler():
    with torch.profiler.profile() as prof:
        with profiling.annotate("engine/generate"):
            torch.ones(4).sum()
    assert "engine/generate" in {e.key for e in prof.key_averages()}


def test_force_sync_waits_only_for_cuda_devices(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: synced.append(dev))
    profiling.force_sync(torch.ones(2), [torch.zeros(3), {"a": torch.ones(1)}], 5)
    assert synced == []  # CPU tensors have nothing to wait for
    profiling.force_sync()


def test_step_timer_reports_rates(monkeypatch):
    clock = iter([0.0, 0.5, 1.0, 1.5])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer()
    assert timer.stats() == {}
    for _ in range(4):
        timer.tick()
    s = timer.stats(batch_size=8)
    assert s["perf/step_time_s"] == 0.5 and s["perf/samples_per_sec"] == 16.0


@pytest.mark.parametrize("batch,cols,normalize,dtype", [
    (5, None, "clip", np.float32), (6, 4, "minmax", np.float32),
    (3, 2, "channel_minmax", np.float32), (4, None, "clip", np.uint8), (2, 3, "clip", "gray"),
])
def test_image_grid_matches_jax(batch, cols, normalize, dtype):
    rng = np.random.default_rng(batch)
    if dtype == np.uint8:
        x = rng.integers(0, 256, (batch, 6, 5, 3), dtype=np.uint8)
    else:
        x = (rng.standard_normal((batch, 6, 5, 1 if dtype == "gray" else 3)) * 0.8).astype(
            np.float32)
    got = images.image_grid(x, cols, normalize)
    want = jax_images.image_grid(x, cols, normalize)
    assert got.size == want.size and got.mode == want.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_latents_to_grayscale_matches_jax():
    rng = np.random.default_rng(3)
    z = (rng.standard_normal((3, 4, 4, 4)) * 3).astype(np.float32)
    z[1] = 0.5  # a constant sample: the 1e-12 floor of the range
    got = images.latents_to_grayscale(z)
    want = jax_images.latents_to_grayscale(z)
    assert got.shape == (3, 4, 4, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
