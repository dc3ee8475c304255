"""The port's segmented SD UNet (``models/sd_segmented.py``) against the JAX
package's, on the CPU, case for case with ``tests/test_sd_segmented.py``.

The tiny config of that file; one set of weights (the port's Flax
initialisers) on both sides through ``models/convert.py``; inputs from
numpy, float32.  The
segmented forward is held against the JAX ``SegmentedSDUNet`` at the SD
parity tests' atol 1e-4 and bit-equal to the port's own ``SDUNet``
(the same ops in the same order); the input VJP against the JAX
``forward_with_input_vjp`` at that package's own bound for it (rtol 5e-4,
atol 1e-5) and against ``torch.autograd.grad`` through the monolith at
rtol 2e-4, atol 1e-6; the stepwise guided generation over
``forward_with_input_vjp`` against the port's one-piece
``custom_guided_generation`` and against the JAX stepwise function.
"""

import os

os.environ["PHENDIFF_PALLAS_INTERPRET"] = "1"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from phendiff_tpu.core import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from phendiff_tpu.core import make_schedule as jax_make_schedule  # noqa: E402
from phendiff_tpu.models import sd_segmented as jax_seg  # noqa: E402
from phendiff_tpu.models.sd_unet import SDUNetConfig as JaxSDConfig  # noqa: E402
from phendiff_tpu.pipelines import transfer as jax_transfer  # noqa: E402
from phendiff_tpu.pipelines.io import flatten_params, unflatten_params  # noqa: E402
from phendiff_tpu_torch.core import scheduler as S  # noqa: E402
from phendiff_tpu_torch.models import convert  # noqa: E402
from phendiff_tpu_torch.models.sd_segmented import SegmentedSDUNet, stage_keys  # noqa: E402
from phendiff_tpu_torch.models.sd_unet import SDUNet, SDUNetConfig  # noqa: E402
from phendiff_tpu_torch.pipelines import transfer  # noqa: E402

torch.set_num_threads(1)

TINY = dict(
    sample_size=8, block_out_channels=(16, 32),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=2, cross_attention_dim=16, attention_head_dim=(2, 4), norm_num_groups=8,
)
ATOL = 1e-4  # the SD parity tests' forward tolerance
VJP_TOL = dict(rtol=2e-4, atol=1e-6)
# against the JAX VJP: its own test's bound for its segmented VJP against
# jax.grad of the monolith (two implementations' f32 convolutions; measured
# 3.3e-6 at most, on an element of 1.3e-3 in a gradient of largest
# magnitude ~4)
JAX_VJP_TOL = dict(rtol=5e-4, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxSDConfig(**TINY)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([3, 500])
    ctx = (rng.standard_normal((2, 77, 16)) * 0.1).astype(np.float32)
    # the port's Flax initialisers; the JAX side gets the same weights
    # through models/convert.py (a JAX init would compile the whole UNet)
    unet = SDUNet(SDUNetConfig(**TINY)).init_weights(torch.Generator().manual_seed(2))
    params = jax.tree.map(jnp.asarray, unflatten_params(convert.to_flax_params(
        unet.state_dict())))
    # one JAX instance: its per-stage programs compile once for every test
    return jax_seg.SegmentedSDUNet(jcfg, dtype=jnp.float32), params, unet, (x, t, ctx)


def _torch(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def test_stage_names_are_jax_names(setup):
    jseg, _, unet, _ = setup
    seg = SegmentedSDUNet(unet)
    assert seg.keys == ["stem", "down:0", "down:1", "mid", "up:0", "up:1", "out"]
    for key in seg.keys:
        assert seg.names(key) == jseg._names(key), key
    # every parameter of the monolith belongs to exactly one stage, as the
    # same tensor
    owned = [n for key in seg.keys for n in seg.param_names(key)]
    assert sorted(owned) == sorted(n for n, _ in unet.named_parameters())
    mono = dict(unet.named_parameters())
    for key in seg.keys:
        for n, p in seg.stages[key].named_parameters():
            assert p is mono[n]


def test_segmented_matches_monolithic(setup):
    jseg, params, unet, (x, t, ctx) = setup
    want = jseg(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    seg = SegmentedSDUNet(unet)
    with torch.no_grad():
        got = seg(*_torch(x, t, ctx))
        mono = unet(*_torch(x, t, ctx))
        on_dict = seg(*_torch(x, t, ctx), params=dict(unet.named_parameters()))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert torch.equal(got, mono) and torch.equal(on_dict, mono)


def test_segmented_init_matches_monolithic(setup):
    """The JAX stage-by-stage init equals the monolith's init; the port
    builds the monolith (``init_weights``) and reads its tensors through the
    stages, so the stages' tree is the monolith's, seed for seed, and it
    carries the JAX segmented init's Flax keys."""
    jseg, _, _, _ = setup
    cfg = SDUNetConfig(**TINY)
    a = SDUNet(cfg).init_weights(torch.Generator().manual_seed(7))
    b = SDUNet(cfg).init_weights(torch.Generator().manual_seed(7))
    seg = SegmentedSDUNet(b)
    merged = {n: p for key in seg.keys for n, p in seg.stages[key].named_parameters()}
    assert sorted(merged) == sorted(n for n, _ in a.named_parameters())
    for n, p in a.named_parameters():
        assert torch.equal(p, merged[n]), n
    jtree = jax.eval_shape(
        jseg.init, jax.random.key(7), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 77, 16)))
    assert set(convert.to_flax_params(merged)) == set(flatten_params(jtree))


def test_segmented_missing_params_fail_loudly(setup):
    _, _, unet, _ = setup
    seg = SegmentedSDUNet(unet)
    bad = {"conv_in.weight": torch.zeros(16, 4, 3, 3), "conv_in.bias": torch.zeros(16)}
    with pytest.raises(KeyError, match="missing"):
        seg(torch.zeros(1, 8, 8, 4), torch.zeros(1, dtype=torch.long), torch.zeros(1, 77, 16),
            params=bad)


def test_input_vjp_matches_monolithic_grad(setup):
    jseg, params, unet, (x, t, ctx) = setup
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    jout, jvjp = jseg.forward_with_input_vjp(params, jnp.asarray(x), jnp.asarray(t),
                                             jnp.asarray(ctx))
    jdx = np.asarray(jvjp(jnp.asarray(w)))

    xt, tt, ct = _torch(x, t, ctx)
    xx = xt.clone().requires_grad_()
    (want_dx,) = torch.autograd.grad(unet(xx, tt, ct), xx, torch.from_numpy(w))
    seg = SegmentedSDUNet(unet)
    out, vjp_fn = seg.forward_with_input_vjp(xt, tt, ct)
    got_dx = vjp_fn(torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(got_dx.numpy(), want_dx.numpy(), **VJP_TOL)
    np.testing.assert_allclose(got_dx.numpy(), jdx, **JAX_VJP_TOL)
    # the parameters received no gradient
    assert all(p.grad is None for p in unet.parameters())


def test_stepwise_guided_generation_matches_one_piece_and_jax(setup):
    """``custom_guided_generation_stepwise`` over the stages' input VJP
    follows the port's one-piece guided generation (autograd through the
    monolith) and the JAX stepwise function, 3 steps at batch 2."""
    jseg, params, unet, (x, _, ctx) = setup
    sched_cfg = dict(num_train_timesteps=20, clip_sample=False)
    schedule = S.make_schedule(S.SchedulerConfig(**sched_cfg), device="cpu")
    seg = SegmentedSDUNet(unet)
    start, emb = _torch(x * 0.5, ctx)
    kw = dict(guidance_loss_scale=0.05, num_inference_steps=3)
    for p in unet.parameters():
        p.requires_grad_(False)
    try:
        got = transfer.custom_guided_generation_stepwise(
            seg.forward_with_input_vjp, schedule, start, emb, **kw)
        want = transfer.custom_guided_generation(unet, schedule, start, emb, **kw)
    finally:
        for p in unet.parameters():
            p.requires_grad_(True)
    jgot = jax_transfer.custom_guided_generation_stepwise(
        lambda xx, tt, e: jseg.forward_with_input_vjp(params, xx, tt, e),
        jax_make_schedule(JaxSchedulerConfig(**sched_cfg)), jnp.asarray(x * 0.5),
        jnp.asarray(ctx), **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=ATOL)


def test_cost_flops_counts_every_stage(setup):
    _, _, unet, (x, t, ctx) = setup
    from torch.utils.flop_counter import FlopCounterMode

    seg = SegmentedSDUNet(unet)
    got = seg.cost_flops(*_torch(x, t, ctx))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        unet(*_torch(x, t, ctx))
    assert got == counter.get_total_flops() > 0
    assert stage_keys(unet.config) == seg.keys
