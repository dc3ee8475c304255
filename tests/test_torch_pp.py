"""The port's pipeline placement (``parallel/pp.py``) against the JAX
package's, on the CPU, case for case with ``tests/test_pp.py``.

This machine has no card, so the stages are placed on ``["cpu"] * k``:
the tests pin the placement logic (which stage goes where, that every
stage's weights sit on its device, that placing twice moves nothing), the
microbatched dispatch (the same numbers as the whole batch) and the
composition with the per-stage training chain (placed equals unplaced,
bit for bit, over two steps with the global clip and the ctx stage).
``stage_keys`` and ``stage_devices`` equal the JAX functions on the same
keys; the placed forward equals the port's monolith bit for bit (the
segmented forward itself is held against the JAX package's in
``tests/test_torch_sd_segmented.py``).  Copies between distinct cards run
on hardware only (``PERF.md`` §7).
"""

import os

os.environ["PHENDIFF_PALLAS_INTERPRET"] = "1"

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from phendiff_tpu.models.sd_unet import SDUNetConfig as JaxSDConfig  # noqa: E402
from phendiff_tpu.parallel import pp as jax_pp  # noqa: E402
from phendiff_tpu_torch.core import scheduler as S  # noqa: E402
from phendiff_tpu_torch.models.sd_segmented import SegmentedSDUNet  # noqa: E402
from phendiff_tpu_torch.models.sd_unet import SDUNet, SDUNetConfig  # noqa: E402
from phendiff_tpu_torch.parallel.pp import PipelinedSDUNet, stage_devices, stage_keys  # noqa: E402
from phendiff_tpu_torch.train.ema import EMAConfig  # noqa: E402
from phendiff_tpu_torch.train.segmented_train import CtxEmbed, SegmentedSDTrainStep  # noqa: E402
from phendiff_tpu_torch.train.train_loop import (  # noqa: E402
    Optimizer,
    OptimizerConfig,
    StepDraws,
)

torch.set_num_threads(1)

TINY = dict(
    sample_size=8, block_out_channels=(16, 32),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, cross_attention_dim=24, attention_head_dim=(2, 4), norm_num_groups=4,
)


@pytest.fixture(scope="module")
def unet():
    return SDUNet(SDUNetConfig(**TINY)).init_weights(torch.Generator().manual_seed(0))


def _inputs(seed, b):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((b, 77, 24)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(ctx)


def test_stage_assignment_contiguous():
    cfg = SDUNetConfig(**TINY)
    keys = stage_keys(cfg)
    assert keys == jax_pp.stage_keys(JaxSDConfig(**TINY))
    assert keys == ["stem", "down:0", "down:1", "mid", "up:0", "up:1", "out"]
    for d in (1, 3, 4, 7, 9):
        devs = list(range(d))  # stand-ins: the rule only indexes the list
        assert stage_devices(keys, devs) == jax_pp.stage_devices(keys, devs)
        order = list(stage_devices(keys, devs).values())
        assert order == sorted(order), "the assignment is contiguous"
        if d <= len(keys):
            assert set(order) == set(devs), "every device takes a stage"


def test_no_card_and_no_devices_raises(unet):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: devices=None takes it")
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelinedSDUNet(unet)


def test_params_placed_on_stage_devices(unet):
    pp = PipelinedSDUNet(unet, devices=["cpu"] * 7)
    placed = pp.place_params()
    assert placed is unet
    ptrs = {n: p.data_ptr() for n, p in unet.named_parameters()}
    for key in pp.keys:
        assert pp.device_of[key] == torch.device("cpu")
        for p in pp.seg.stages[key].parameters():
            assert p.device == pp.device_of[key]
    pp.place_params()  # idempotent: nothing moves
    assert {n: p.data_ptr() for n, p in unet.named_parameters()} == ptrs


def test_config_built_pipeline_places_a_state_dict(unet):
    pp = PipelinedSDUNet(SDUNetConfig(**TINY), devices=["cpu", "cpu", "cpu"])
    assert all(p.is_meta for p in pp.unet.parameters())
    pp.place_params(unet.state_dict())
    x, ctx = _inputs(1, 2)
    t = torch.tensor([1, 2])
    with torch.no_grad():
        assert torch.equal(pp(x, t, ctx), unet(x, t, ctx))


def test_pipelined_forward_matches_monolith(unet):
    """The placed stages give the monolith's output bit for bit (the same
    ops in the same order: the segmented forward is held against the JAX
    package's in ``tests/test_torch_sd_segmented.py``)."""
    x, ctx = _inputs(1, 4)
    t = torch.tensor([0, 5, 9, 13])
    pp = PipelinedSDUNet(unet, devices=["cpu"] * 7)
    pp.place_params()
    with torch.no_grad():
        got = pp(x, t, ctx)
        mono = unet(x, t, ctx)
    assert got.shape == x.shape and torch.equal(got, mono)


def test_microbatched_matches_whole_batch(unet):
    x, ctx = _inputs(3, 8)
    t = torch.arange(8)
    pp = PipelinedSDUNet(unet, devices=["cpu"] * 7)
    pp.place_params()
    with torch.no_grad():
        whole = pp(x, t, ctx)
        piped = pp(x, t, ctx, num_microbatches=4)
        scalar_t = pp(x, 5, ctx, num_microbatches=2)
        want_scalar = unet(x, torch.full((8,), 5), ctx)
    # other batch sizes take other f32 summation orders
    np.testing.assert_allclose(piped.numpy(), whole.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(scalar_t.numpy(), want_scalar.numpy(), rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="not divisible"):
        pp(x, t, ctx, num_microbatches=3)


def test_fewer_devices_than_stages(unet):
    pp = PipelinedSDUNet(unet, devices=["cpu"] * 3)
    assert len(set(stage_devices(pp.keys, [0, 1, 2]).values())) == 3
    pp.place_params()
    x, ctx = _inputs(5, 2)
    t = torch.tensor([1, 2])
    with torch.no_grad():
        assert torch.equal(pp(x, t, ctx), unet(x, t, ctx))


def test_placed_input_vjp_equals_segmented(unet):
    x, ctx = _inputs(6, 2)
    t = torch.tensor([3, 7])
    w = torch.from_numpy(np.random.default_rng(7).standard_normal(x.shape).astype(np.float32))
    pp = PipelinedSDUNet(unet, devices=["cpu"] * 4)
    pp.place_params()
    out, vjp_fn = pp.forward_with_input_vjp(x, t, ctx)
    want_out, want_vjp = SegmentedSDUNet(unet).forward_with_input_vjp(x, t, ctx)
    assert torch.equal(out, want_out) and torch.equal(vjp_fn(w), want_vjp(w))


def test_pp_training_composes_with_vjp_chain(unet):
    """The per-stage VJP chain with its stages placed (``device_of``) gives
    bit-equal params, EMA and loss against the unplaced chain over two
    steps with the global clip and the ctx stage."""
    cfg = SDUNetConfig(**TINY)
    schedule = S.make_schedule(S.SchedulerConfig(num_train_timesteps=20, clip_sample=False),
                               device="cpu")
    rng = np.random.default_rng(8)
    latents = torch.from_numpy((rng.standard_normal((4, 8, 8, 4)) * 0.5).astype(np.float32))
    labels = torch.tensor([0, 1, 0, 1])
    table = torch.from_numpy(rng.standard_normal((2, 24)).astype(np.float32) / 4)
    draws = [StepDraws(noise=torch.from_numpy(rng.standard_normal((4, 8, 8, 4)).astype(
        np.float32)), timesteps=torch.from_numpy(rng.integers(0, 20, 4)), uncond=bool(i))
        for i in range(2)]
    placement = stage_devices(stage_keys(cfg), ["cpu"] * 7)
    results = {}
    for name, device_of in (("single", None), ("pp", placement)):
        with torch.device("meta"):
            seg = SegmentedSDUNet(SDUNet(cfg))
            ctx_mod = CtxEmbed(2, 24)
        step = SegmentedSDTrainStep(
            seg, schedule, Optimizer(OptimizerConfig(learning_rate=1e-3, max_grad_norm=None)),
            proba_uncond=0.1, ema=EMAConfig(), max_grad_norm=1.0, clip_mode="cache",
            ctx_module=ctx_mod, device_of=device_of)
        params = {n: p.detach().clone() for n, p in unet.named_parameters()}
        params["class_embedding.embedding.weight"] = table.clone()
        params = step.place_params(params)
        opt = step.init_opt_state(params)
        ema = {n: t.clone() for n, t in params.items()}
        for i in range(2):
            _, _, _, m = step(params, opt, latents, labels, draws[i], ema_params=ema, step=i)
        results[name] = (params, ema, m)
    for idx in (0, 1):
        a, b = results["single"][idx], results["pp"][idx]
        assert list(a) == list(b)
        for n in a:
            assert torch.equal(a[n], b[n]), n
    assert torch.equal(results["single"][2]["loss"], results["pp"][2]["loss"])
