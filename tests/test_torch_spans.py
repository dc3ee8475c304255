"""The port's spans (``obs/profiling.py``): off by default at the cost of a
flag check, on under a ``torch.profiler`` or a ``recording()`` block, held
in memory on the profiler's clock, and placed at the layer boundaries of
the train step and the DDIB loop.

Imports only torch and the port, so the CUDA cases also run where JAX is
absent:

    python -m pytest tests/test_torch_spans.py --noconftest -q

The CUDA cases carry the ``cuda`` marker and skip without a card.
"""

import time
import types

import numpy as np
import pytest
import torch
from torch.func import functional_call

from phendiff_tpu_torch.core import scheduler as S
from phendiff_tpu_torch.models.config import UNet2DConfig
from phendiff_tpu_torch.models.unet2d import CondUNet2D
from phendiff_tpu_torch.obs import profiling
from phendiff_tpu_torch.pipelines.transfer import ddib, inverted_regeneration
from phendiff_tpu_torch.train import train_loop as T
from phendiff_tpu_torch.train.trainer import batches, step_times

TINY = UNet2DConfig(
    sample_size=8, block_out_channels=(8, 16),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1, norm_num_groups=4, attention_head_dim=4, num_class_embeds=2,
)
PHASES = ["train/forward", "train/backward", "train/allreduce", "train/optimizer", "train/ema"]


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.recorder().clear()
    yield
    profiling.recorder().clear()


@pytest.fixture(params=["profiler", "recording"])
def on(request):
    """Spans on: under a profiler, or in a ``recording()`` block alone."""
    if request.param == "profiler":
        with torch.profiler.profile():
            yield request.param
    else:
        with profiling.recording():
            yield request.param


def _names(spans):
    return [s.name for s in spans]


def test_a_span_that_is_off_calls_no_profiler_and_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    with profiling.annotate("train/step") as span:
        with profiling.annotate("train/forward"):
            pass
    assert span is None
    # no object is made for a span that is off
    assert profiling.annotate("a") is profiling.annotate("b", device="cpu")
    assert profiling.recorder().spans() == [] and profiling.recorder().totals() == {}


def test_nested_spans_close_in_order_with_their_totals(on):
    with profiling.annotate("outer") as outer:
        with profiling.annotate("inner") as first:
            with profiling.annotate("leaf") as leaf:
                time.sleep(0.002)
        with profiling.annotate("inner") as second:
            pass
    with profiling.annotate("other") as other:
        pass
    rec = profiling.recorder()
    # kept in the order they closed
    assert rec.spans() == [leaf, first, second, outer, other]
    assert outer.start_ns <= first.start_ns <= leaf.start_ns <= leaf.end_ns <= first.end_ns
    assert first.end_ns <= second.start_ns <= second.end_ns <= outer.end_ns <= other.start_ns
    assert leaf.host_ns >= 2_000_000 and leaf.seconds == leaf.host_ns / 1e9
    totals = rec.totals()
    assert totals["inner"] == profiling.Totals(2, first.host_ns + second.host_ns)
    assert totals["outer"] == profiling.Totals(1, outer.host_ns)
    assert rec.spans("inner") == [first, second]
    assert rec.last("inner") is second and rec.last("missing") is None


def test_totals_since_a_snapshot(on):
    rec = profiling.recorder()
    with profiling.annotate("a"):
        pass
    before = rec.totals()
    with profiling.annotate("a") as a:
        with profiling.annotate("b") as b:
            pass
    spent = rec.since(before)
    assert spent == {"a": profiling.Totals(1, a.host_ns), "b": profiling.Totals(1, b.host_ns)}


def test_the_ring_keeps_the_last_spans_and_totals_count_all(on, monkeypatch):
    monkeypatch.setattr(profiling, "RING", 4)
    monkeypatch.setattr(profiling, "_RECORDER", profiling.Recorder())
    made = []
    for _ in range(6):
        with profiling.annotate("unit") as span:
            made.append(span)
    rec = profiling.recorder()
    assert rec.spans() == made[2:]
    assert rec.totals()["unit"].count == 6 and rec.last("unit") is made[-1]
    rec.clear()
    assert rec.spans() == [] and rec.totals() == {} and rec.last("unit") is None


def test_a_recorder_keeps_a_profilers_spans_after_it_stops():
    with torch.profiler.profile():
        with profiling.annotate("transfer/denoise"):
            pass
    assert _names(profiling.recorder().spans()) == ["transfer/denoise"]
    with profiling.annotate("transfer/denoise"):  # off again
        pass
    assert len(profiling.recorder().spans()) == 1


def test_a_span_is_its_profiler_event_on_the_same_clock():
    """Each span's start and end against its profiler event's: typically a
    few µs apart; the median within 100 µs, so that a gap of the host's
    scheduler inside one span does not decide the test."""
    x = torch.randn(64, 64)
    with torch.profiler.profile() as prof:
        with profiling.annotate("warm/up"):
            x @ x
        for i in range(20):
            with profiling.annotate(f"clock/{i}"):
                x @ x
    spans = {s.name: s for s in profiling.recorder().spans()}
    gaps = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("clock/"):
            s = spans[e.name()]
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            gaps.append(max(abs(s.start_ns - start), abs(s.end_ns - end)))
    assert len(gaps) == 20
    assert np.median(gaps) < 100_000 and max(gaps) < 5_000_000


def _tiny_step(encode):
    torch.manual_seed(0)
    model = CondUNet2D(TINY)
    params = {n: p.detach().clone().requires_grad_() for n, p in model.named_parameters()}
    encode_fn = {None: None,
                 "frozen": lambda images, draws: images * 0.5,
                 "in_grad": lambda p, images, draws: images * 0.5}[encode]
    cfg = T.TrainConfig(proba_uncond=0.5)
    opt = T.make_optimizer(cfg.optimizer)
    step = T.make_train_step(
        lambda p, x, t, ce: functional_call(model, p, (x, t), {"class_emb": ce}),
        lambda p, lab: p["class_embedding.weight"][lab],
        S.make_schedule(S.SchedulerConfig(num_train_timesteps=20), device="cpu"), cfg, opt,
        encode_fn, encode == "in_grad")
    return step, T.init_train_state(params, opt)


def _batch(b=3):
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (b, 8, 8, 3), dtype=np.uint8))
    return images, torch.tensor([0, 1, 1][:b])


@pytest.mark.parametrize("encode", [None, "frozen", "in_grad"])
def test_the_train_step_is_one_span_with_its_phases_in_order(encode):
    step, state = _tiny_step(encode)
    images, labels = _batch()
    draws = T.make_draws(0, 0, (3, 8, 8, 3), 20, 0.5, "cpu")
    with profiling.recording() as rec:
        state, metrics = step(state, (images, labels), draws)
    spans = rec.spans()
    (root,) = rec.spans("train/step")
    assert spans[-1] is root
    assert _names(spans[:-1]) == (["train/encode"] if encode else []) + PHASES
    assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in spans[:-1])
    assert sum(s.host_ns for s in spans[:-1]) <= root.host_ns
    assert np.isfinite(float(metrics["loss"])) and state.step == 1


def test_trainer_log_figures_come_from_the_spans():
    class Loader:
        def epoch(self, epoch, skip):
            for _ in range(2):
                images, labels = _batch()
                yield images.numpy(), labels.numpy()

    step, state = _tiny_step(None)
    rows = []
    with profiling.recording() as rec:
        for k, (host, batch, data) in enumerate(batches(Loader(), 0, 0, "cpu")):
            draws = T.make_draws(0, k, (3, 8, 8, 3), 20, 0.5, "cpu")
            before = rec.totals()
            state, _ = step(state, batch, draws)
            root = rec.last("train/step")
            rows.append((data, step_times(data, root, rec.since(before)), root))
    assert len(rows) == 2 and len(rec.spans("train/step")) == 2
    for data, times, root in rows:
        assert data.name == "train/data" and data.end_ns <= root.start_ns
        assert times["perf/t_data_s"] == data.seconds
        assert times["perf/t_dispatch_s"] == (root.end_ns - data.end_ns) / 1e9
        assert sorted(times) == sorted(["perf/t_data_s", "perf/t_dispatch_s"]
                                       + [f"perf/host_ms/{p}" for p in PHASES])
        assert sum(times[f"perf/host_ms/{p}"] for p in PHASES) <= root.host_ns / 1e6


def test_trainer_helpers_record_their_spans_outside_a_run():
    """``batches`` and the Trainer's metrics fetch open their own spans, so
    they work where nothing else records."""
    from phendiff_tpu_torch.train.trainer import Trainer

    class Loader:
        def epoch(self, epoch, skip):
            yield _batch()[0].numpy(), _batch()[1].numpy()

    class Tracker:
        def __init__(self):
            self.logged = []

        def log(self, host, step):
            self.logged.append((step, host))

    assert not torch._C._autograd._profiler_enabled()
    ((_, _, data),) = list(batches(Loader(), 0, 0, "cpu"))
    assert data.name == "train/data" and data.host_ns >= 0
    trainer = Trainer.__new__(Trainer)
    trainer.tracker, trainer.config = Tracker(), types.SimpleNamespace(train_batch_size=3)
    pending = [(1, 0, {"loss": torch.tensor(0.5)}, {})]
    trainer._flush_metrics(pending, profiling.StepTimer())
    ((step_no, host),) = trainer.tracker.logged
    assert step_no == 1 and host["loss"] == 0.5
    assert host["perf/t_await_s"] == profiling.recorder().last("train/metrics").seconds


@pytest.mark.parametrize("steps", [1, 3])
def test_ddib_has_a_denoiser_span_a_call(steps):
    sched = S.make_schedule(S.SchedulerConfig(num_train_timesteps=20), device="cpu")
    images = torch.rand(2, 4, 4, 3) * 2 - 1
    calls = []

    def denoiser(x, t, emb):
        calls.append(profiling.recorder().totals().get("transfer/denoise"))
        return x * 0.1 + emb[:, None, None, :1]

    emb = torch.randn(2, 4)
    with profiling.recording() as rec:
        ddib(denoiser, sched, images, emb, -emb, num_inference_steps=steps)
        inverted_regeneration(denoiser, sched, images, emb, num_inference_steps=steps)
    assert _names(rec.spans()) == ["transfer/denoise"] * (4 * steps)
    # each call ran inside its span, which closed before the next call
    assert [c.count if c else 0 for c in calls] == list(range(4 * steps))
    assert len(calls) == 4 * steps and rec.latency_ms("transfer/denoise") == []


def test_a_dit_call_records_its_three_spans_under_the_denoiser_span():
    from phendiff_tpu_torch.models import dit as D

    cfg = D.DiTConfig(input_size=4, hidden_size=144, depth=2, num_heads=2, num_classes=3)
    model = D.DiT(cfg).init_weights(torch.Generator().manual_seed(0))
    sched = S.make_schedule(S.SchedulerConfig(num_train_timesteps=20, clip_sample=False),
                            device="cpu")
    x = torch.randn(2, 4, 4, 4)
    glue, calls = D.glue_launches, D.forward_calls
    with profiling.recording() as rec:
        ddib(lambda z, t, y: model.eps_of(model(z, t, y)), sched, x, torch.tensor([0, 1]),
             torch.tensor([1, 0]), num_inference_steps=2)
    parts = ["dit/condition", "dit/blocks", "dit/final"]
    assert _names(rec.spans()) == (parts + ["transfer/denoise"]) * 4
    for root in rec.spans("transfer/denoise"):
        inner = [s for s in rec.spans() if s.name in parts
                 and root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns]
        assert _names(inner) == parts
    assert D.forward_calls - calls == 4
    assert D.glue_launches - glue == 4 * (7 * cfg.depth + 2)


def test_train_allreduce_is_a_span_of_the_step_under_a_world_one_gloo_group(tmp_path):
    import torch.distributed as dist

    from phendiff_tpu_torch.parallel import mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}", rank=0,
                            world_size=1)
    try:
        step, state = _tiny_step(None)
        images, labels = _batch()
        draws = T.make_draws(0, 0, (3, 8, 8, 3), 20, 0.5, "cpu")
        with profiling.recording() as rec:
            state, metrics = step(state, (images, labels), draws)
        (root,) = rec.spans("train/step")
        (reduce,) = rec.spans("train/allreduce")
        assert _names(rec.spans()[:-1]) == PHASES
        assert rec.last("train/backward").end_ns <= reduce.start_ns
        assert reduce.end_ns <= rec.last("train/optimizer").start_ns <= root.end_ns
        assert np.isfinite(float(metrics["loss"]))
    finally:
        mesh.destroy()


def test_step_timer_gives_whole_run_rates(monkeypatch):
    clock = iter([0.0, 1.0, 1.5, 3.0, 3.2])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer()
    for _ in range(5):
        timer.tick()
    s = timer.stats(batch_size=4)
    assert s["perf/step_time_s"] == pytest.approx(0.8)
    assert s["perf/samples_per_sec"] == pytest.approx(5.0)
    # ticked with the steps' spans: the times they closed
    timer = profiling.StepTimer()
    for end_s in (10.0, 10.5, 12.0):
        span = profiling.Span("train/step")
        span.end_ns = int(end_s * 1e9)
        timer.tick(span)
    assert timer.stats(batch_size=8)["perf/samples_per_sec"] == pytest.approx(8.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_no_event_is_recorded_while_the_stream_captures(cuda):
    x = torch.randn(256, 256, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x @ x  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.profiler.profile():
        with torch.cuda.graph(graph):
            with profiling.annotate("transfer/denoise", device=cuda):
                y = x @ x
        graph.replay()
        with profiling.annotate("transfer/denoise", device=cuda):
            y = y @ x
    rec = profiling.recorder()
    captured, eager = rec.spans("transfer/denoise")
    assert captured._event is None and eager._event is not None
    (latency,) = rec.latency_ms("transfer/denoise")
    assert eager._done_ns is not None and captured._done_ns is None and latency > 0.0


@pytest.mark.cuda
def test_latency_reads_the_queue_the_host_left(cuda):
    x = torch.randn(4096, 4096, device=cuda)
    torch.cuda.synchronize()
    with profiling.recording():
        with profiling.annotate("train/step", device=cuda):
            x = x @ x  # no profiler: no event
    with torch.profiler.profile():
        with profiling.annotate("train/step", device=cuda) as ahead:
            for _ in range(20):
                x = (x @ x).clamp_(-1, 1)  # tens of ms of queued work
        torch.cuda.synchronize()
        with profiling.annotate("train/step", device=cuda) as idle:
            pass  # nothing queued: the device is done at once
    rec = profiling.recorder()
    assert rec.spans("train/step")[0]._event is None
    queued, done = rec.latency_ms("train/step")
    assert queued > ahead.host_ns / 1e6 + 1.0
    assert -0.5 < done - idle.host_ns / 1e6 < 0.5


@pytest.mark.cuda
def test_engine_warmup_captures_under_a_profiler_and_replays_equal_eager(cuda):
    from phendiff_tpu_torch.pipelines.conditional_ddim import to_images
    from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
    from phendiff_tpu_torch.serving import EngineConfig, InferenceEngine

    small = UNet2DConfig(
        sample_size=32, block_out_channels=(32, 64),
        down_block_types=("DownBlock2D", "AttnDownBlock2D"),
        up_block_types=("AttnUpBlock2D", "UpBlock2D"),
        layers_per_block=1, norm_num_groups=8, attention_head_dim=8, num_class_embeds=2,
    )
    sched = S.SchedulerConfig(num_train_timesteps=1000, timestep_spacing="trailing",
                              clip_sample=False)
    pipe = ConditionalDDIMPipeline.init_random(
        small, sched, seed=0, dtype=torch.bfloat16, device="cuda").cast_params(torch.bfloat16)
    eng = InferenceEngine(pipe, EngineConfig(max_batch=8, num_inference_steps=5,
                                             ops=("transfer",)))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        eng.warmup()  # an eager run on a side stream, then the capture
    rec = profiling.recorder()
    calls = rec.spans("transfer/denoise")
    assert len(calls) == 20  # 10 eager, then 10 captured
    assert [s._event is not None for s in calls] == [True] * 10 + [False] * 10
    assert len(rec.latency_ms("transfer/denoise")) == 10
    assert "transfer/denoise" in {e.key for e in prof.key_averages()}

    rng = np.random.default_rng(0)
    images, src = rng.random((8, 32, 32, 3)).astype(np.float32), rng.integers(0, 2, 8)
    x = torch.as_tensor(images * 2.0 - 1.0, device=cuda)
    s, t = torch.as_tensor(src, device=cuda), torch.as_tensor(1 - src, device=cuda)
    want = ddib(pipe.denoiser_fn(), pipe.schedule, x, pipe.class_embeddings(s),
                pipe.class_embeddings(t), num_inference_steps=5)
    np.testing.assert_array_equal(eng.transfer(images, src), to_images(want).cpu().numpy())
