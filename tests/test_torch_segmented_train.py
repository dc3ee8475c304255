"""The port's per-stage VJP train step (``train/segmented_train.py``) against
the JAX package's ``SegmentedSDTrainStep``, on the CPU, case for case with
``tests/test_segmented_train.py``.

A tiny SD UNet (that file's config at one layer a block, as
``tests/test_pp.py``'s); one set of weights (the port's Flax initialisers)
on both sides through ``models/convert.py``; latents and the conditioning
from numpy; the port gets the JAX step's own draws (``_prepare``'s split
of the step key: timesteps, noise, coin flip) as ``StepDraws``.  With a
test-only SGD at lr 1 the parameters after a step are the parameters
minus the (clipped) gradients, so gradients, the global clip in both modes,
the ``ctx`` stage, the CFG-dropout zero gradient and v-prediction with EMA
are held against the JAX step at rtol 2e-4, atol 1e-6 (f32 sums in another
order); the bf16 gradient cache at the JAX test's own bound (5e-4 on the
parameters after an AdamW step).  The JAX steps share their compiled stage
VJPs (one SD UNet, one optimizer), so each program compiles once.
"""

import os

os.environ["PHENDIFF_PALLAS_INTERPRET"] = "1"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch.func import functional_call  # noqa: E402

from phendiff_tpu.core import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from phendiff_tpu.core import make_schedule as jax_make_schedule  # noqa: E402
from phendiff_tpu.models.sd_segmented import SegmentedSDUNet as JaxSegmented  # noqa: E402
from phendiff_tpu.models.sd_unet import SDUNetConfig as JaxSDConfig  # noqa: E402
from phendiff_tpu.pipelines.io import flatten_params, unflatten_params  # noqa: E402
from phendiff_tpu.train import segmented_train as JS  # noqa: E402
from phendiff_tpu.train.ema import EMAConfig as JaxEMAConfig  # noqa: E402
from phendiff_tpu_torch.core import scheduler as S  # noqa: E402
from phendiff_tpu_torch.models import convert  # noqa: E402
from phendiff_tpu_torch.models.sd_segmented import SegmentedSDUNet  # noqa: E402
from phendiff_tpu_torch.models.sd_unet import SDUNet, SDUNetConfig  # noqa: E402
from phendiff_tpu_torch.train.ema import EMAConfig, ema_update  # noqa: E402
from phendiff_tpu_torch.train.segmented_train import CtxEmbed, SegmentedSDTrainStep  # noqa: E402
from phendiff_tpu_torch.train.train_loop import Optimizer, OptimizerConfig, StepDraws  # noqa: E402

torch.set_num_threads(1)

TINY = dict(
    sample_size=8, block_out_channels=(16, 32),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, cross_attention_dim=16, attention_head_dim=(2, 4), norm_num_groups=8,
)
SCHED = dict(num_train_timesteps=20, clip_sample=False)
TOL = dict(rtol=2e-4, atol=1e-6)
TABLE = "class_embedding.embedding.weight"
# what the JAX steps share: programs over the same modules and dtype, and
# (PER_OPTIMIZER) over the same optimizer object
SHARED = ("_vjp", "_sq_norm", "_add", "_loss_head", "_scale_ct", "_mask_ct", "_mask_ctx",
          "_ctx_vjp")
PER_OPTIMIZER = ("_apply_stage", "_ema_stage")


class SGD:
    """Test-only SGD in the port's optimizer interface (per leaf)."""

    def __init__(self, lr: float = 1.0):
        self.lr = lr

    def init(self, params):
        return None

    @torch.no_grad()
    def update(self, grads, state, params):
        for n, p in params.items():
            p.sub_(self.lr * grads[n].to(p.dtype))


@pytest.fixture(scope="module")
def env():
    cfg = SDUNetConfig(**TINY)
    unet = SDUNet(cfg).init_weights(torch.Generator().manual_seed(2))
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = (rng.standard_normal((2, 77, 16)) * 0.1).astype(np.float32)
    table = (rng.standard_normal((2, 16)) / 4).astype(np.float32)
    params = {n: p.detach().clone() for n, p in unet.named_parameters()}
    jseg = JaxSegmented(JaxSDConfig(**TINY), dtype=jnp.float32)
    return dict(cfg=cfg, unet=unet, lat=lat, ctx=ctx, table=table, params=params, jseg=jseg,
                labels=np.array([0, 1], np.int32), sgd=optax.sgd(1.0), base={})


def to_jax(params):
    return jax.tree.map(jnp.asarray, unflatten_params(convert.to_flax_params(params)))


def to_port(tree, cfg):
    flat = flatten_params(tree)
    ce = {k: v for k, v in flat.items() if k.startswith("params/class_embedding/")}
    out = convert.from_flax_params({k: v for k, v in flat.items() if k not in ce}, cfg)
    for v in ce.values():
        out[TABLE] = torch.from_numpy(np.array(v))
    return out


def jax_run(env, key, *, sched=SCHED, optimizer=None, with_ctx=False, ema=None,
            cond=None, **kw):
    """One JAX segmented step from ``env``'s weights; (params, ema, metrics)
    in the port's names."""
    optimizer = optimizer or env["sgd"]
    ctx_mod = JS.CtxEmbed(num_classes=2, embedding_dim=16) if with_ctx else None
    step = JS.SegmentedSDTrainStep(env["jseg"], jax_make_schedule(JaxSchedulerConfig(**sched)),
                                   optimizer, ctx_module=ctx_mod, ema=ema, **kw)
    for names, owner in ((SHARED, None), (PER_OPTIMIZER, id(optimizer))):
        for a in names:
            if hasattr(step, a):
                setattr(step, a, env["base"].setdefault((a, owner), getattr(step, a)))
    p = dict(env["params"])
    if with_ctx:
        p[TABLE] = torch.from_numpy(env["table"])
    params = to_jax(p)
    e = jax.tree.map(jnp.copy, params) if ema is not None else None
    cond = cond if cond is not None else (env["labels"] if with_ctx else env["ctx"])
    p2, _, e2, m = step(params, step.init_opt_state(params), jnp.asarray(env["lat"]),
                        jnp.asarray(cond), jax.random.key(key), ema_params=e)
    return (to_port(p2, env["cfg"]), None if e2 is None else to_port(e2, env["cfg"]),
            {k: np.asarray(v) for k, v in m.items()})


def jax_draws(key, shape, proba_uncond=0.0):
    """The JAX step's ``_prepare`` draws of ``jax.random.key(key)``."""
    k_t, k_n, k_flip = jax.random.split(jax.random.key(key), 3)
    t = jax.random.randint(k_t, (shape[0],), 0, SCHED["num_train_timesteps"], dtype=jnp.int32)
    noise = jax.random.normal(k_n, shape, jnp.float32)
    uncond = bool(jax.random.bernoulli(k_flip, proba_uncond)) if proba_uncond > 0 else False
    return StepDraws(noise=torch.from_numpy(np.array(noise)),
                     timesteps=torch.from_numpy(np.asarray(t)).long(), uncond=uncond)


def port_run(env, key, *, sched=SCHED, optimizer=None, with_ctx=False, ema=None,
             dtype=torch.float32, cond=None, proba_uncond=0.0, **kw):
    """The port's step on the same weights and ``jax_draws(key)``;
    (params before, params after, ema after, metrics)."""
    with torch.device("meta"):
        seg = SegmentedSDUNet(SDUNet(env["cfg"], dtype=dtype))
        ctx_mod = CtxEmbed(2, 16, dtype=dtype) if with_ctx else None
    schedule = S.make_schedule(S.SchedulerConfig(**sched), device="cpu")
    step = SegmentedSDTrainStep(seg, schedule, optimizer or SGD(), proba_uncond=proba_uncond,
                                ctx_module=ctx_mod, ema=ema, **kw)
    p0 = dict(env["params"])
    if with_ctx:
        p0[TABLE] = torch.from_numpy(env["table"])
    params = {n: t.clone() for n, t in p0.items()}
    e = {n: t.clone() for n, t in p0.items()} if ema is not None else None
    cond = cond if cond is not None else (env["labels"] if with_ctx else env["ctx"])
    cond = torch.from_numpy(cond).long() if with_ctx else torch.from_numpy(cond)
    draws = jax_draws(key, env["lat"].shape, proba_uncond)
    params, opt, e, m = step(params, step.init_opt_state(params), torch.from_numpy(env["lat"]),
                             cond, draws, ema_params=e)
    return p0, params, e, m, opt


def _assert_grads(p0, p1, want_grads, scale=1.0, names=None, tol=TOL):
    for n in names or want_grads:
        np.testing.assert_allclose((p0[n] - p1[n]).numpy(), scale * want_grads[n].numpy(),
                                   err_msg=n, **tol)


def test_segmented_gradient_values_match(env):
    """Loss, leaf-by-leaf gradients and the conditioning gradient against the
    JAX step and against autograd through the port's monolith."""
    jp, _, jm = jax_run(env, 11)
    p0, p1, _, m, _ = port_run(env, 11)
    assert np.isclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert float(m["nonfinite"]) == 0.0
    np.testing.assert_allclose(m["ctx_grad"].numpy(), jm["ctx_grad"], **TOL)
    jgrads = {n: p0[n] - jp[n] for n in p0}
    _assert_grads(p0, p1, jgrads)

    draws = jax_draws(11, env["lat"].shape)
    schedule = S.make_schedule(S.SchedulerConfig(**SCHED), device="cpu")
    noisy = S.add_noise(schedule, torch.from_numpy(env["lat"]), draws.noise, draws.timesteps)
    leaves = {n: t.clone().requires_grad_() for n, t in p0.items()}
    c = torch.from_numpy(env["ctx"]).requires_grad_()
    pred = functional_call(env["unet"], leaves, (noisy, draws.timesteps, c))
    loss = (pred - draws.noise).square().mean()
    grads = torch.autograd.grad(loss, [*leaves.values(), c])
    _assert_grads(p0, p1, dict(zip(leaves, grads)))
    np.testing.assert_allclose(m["ctx_grad"].numpy(), grads[-1].numpy(), **TOL)


def test_segmented_step_learns(env):
    """AdamW (no clip), the same batch 8 times: the loss falls and every
    tensor moves (a dropped cotangent route leaves one still)."""
    with torch.device("meta"):
        seg = SegmentedSDUNet(SDUNet(env["cfg"]))
    opt = Optimizer(OptimizerConfig(learning_rate=1e-3, max_grad_norm=None,
                                    adam_weight_decay=0.0))
    step = SegmentedSDTrainStep(seg, S.make_schedule(S.SchedulerConfig(**SCHED), device="cpu"),
                                opt)
    params = {n: t.clone() for n, t in env["params"].items()}
    state = step.init_opt_state(params)
    draws = jax_draws(3, env["lat"].shape)
    losses = []
    for _ in range(8):
        _, _, _, m = step(params, state, torch.from_numpy(env["lat"]),
                          torch.from_numpy(env["ctx"]), draws)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    still = [n for n in params if torch.equal(params[n], env["params"][n])]
    assert not still, f"{len(still)} tensors received no update"


def test_segmented_step_bf16_compute(env):
    """bf16 compute over f32 master weights: the loss head's cotangent
    carries the network's bf16 dtype, and the step is finite."""
    p0, p1, _, m, _ = port_run(env, 4, dtype=torch.bfloat16)
    assert np.isfinite(float(m["loss"])) and m["ctx_grad"].dtype == torch.bfloat16
    assert all(p1[n].dtype == torch.float32 and torch.isfinite(p1[n]).all() for n in p1)
    assert any(not torch.equal(p0[n], p1[n]) for n in p1)


def test_segmented_v_prediction_and_cfg_dropout_and_ema(env):
    """v-prediction targets, the shared coin flip (p = 0.5) and the
    per-stage EMA against the JAX step; the EMA follows the decay law."""
    sched_v = dict(SCHED, prediction_type="v_prediction")
    jp, je, jm = jax_run(env, 5, sched=sched_v, proba_uncond=0.5, ema=JaxEMAConfig())
    p0, p1, e1, m, _ = port_run(env, 5, sched=sched_v, proba_uncond=0.5, ema=EMAConfig())
    assert np.isclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    for n in p1:
        np.testing.assert_allclose(p1[n].numpy(), jp[n].numpy(), err_msg=n, **TOL)
        np.testing.assert_allclose(e1[n].numpy(), je[n].numpy(), err_msg=n, **TOL)
    ref = {n: t.clone() for n, t in p0.items()}
    ema_update(EMAConfig(), ref, p1, 1)
    for n in ref:
        torch.testing.assert_close(e1[n], ref[n], rtol=1e-5, atol=1e-7)


def test_chained_global_norm_optimizer_rejected(env):
    """The port's ``Optimizer`` clips by the global norm (the one-program
    step's): per-stage application would clip per stage, so it is refused;
    built with ``max_grad_norm=None`` it is per-leaf AdamW."""
    with torch.device("meta"):
        seg = SegmentedSDUNet(SDUNet(env["cfg"]))
    schedule = S.make_schedule(S.SchedulerConfig(**SCHED), device="cpu")
    with pytest.raises(ValueError, match="max_grad_norm"):
        SegmentedSDTrainStep(seg, schedule, Optimizer(OptimizerConfig()))
    with pytest.raises(ValueError, match="PER-LEAF"):
        SegmentedSDTrainStep(seg, schedule, Optimizer(OptimizerConfig(max_grad_norm=5.0)))
    SegmentedSDTrainStep(seg, schedule, Optimizer(OptimizerConfig(max_grad_norm=None)))


@pytest.mark.parametrize("mode", ["cache", "recompute"])
def test_global_clip_cache_and_recompute_match(env, mode):
    """``max_grad_norm`` below the norm: every gradient is scaled by
    max_norm / norm, in both modes, as in the JAX step."""
    _, _, raw = jax_run(env, 11)
    max_norm = float(raw["grad_norm"]) / 2.0
    jp, _, jm = jax_run(env, 11, max_grad_norm=max_norm, clip_mode=mode)
    p0, p1, _, m, _ = port_run(env, 11, max_grad_norm=max_norm, clip_mode=mode)
    assert np.isclose(float(m["grad_norm"]), float(raw["grad_norm"]), rtol=1e-5)
    assert np.isclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    _assert_grads(p0, p1, {n: p0[n] - jp[n] for n in p0})


def test_ctx_stage_trains_class_embedding(env):
    """With ``ctx_module=CtxEmbed(...)`` the table gets the JAX step's
    gradient (through ``pad_to_clip_sequence``), and no ``ctx_grad`` is left."""
    jp, _, jm = jax_run(env, 11, with_ctx=True)
    p0, p1, _, m, opt = port_run(env, 11, with_ctx=True)
    assert "ctx_grad" not in m and "ctx_grad" not in jm and "ctx" in opt
    _assert_grads(p0, p1, {TABLE: p0[TABLE] - jp[TABLE]})
    _assert_grads(p0, p1, {n: p0[n] - jp[n] for n in p0})


def test_ctx_stage_cfg_dropout_blocks_embedding_grad(env):
    """proba_uncond = 1 zeros the conditioning and its gradient: the table
    does not move."""
    p0, p1, _, _, _ = port_run(env, 3, with_ctx=True, proba_uncond=1.0)
    assert torch.equal(p1[TABLE], p0[TABLE])
    assert not torch.equal(p1["conv_in.weight"], p0["conv_in.weight"])


@pytest.mark.parametrize("mode", ["cache", "recompute"])
def test_global_clip_with_ctx_stage_matches(env, mode):
    """The global norm spans the UNet's and the table's gradients."""
    _, _, raw = jax_run(env, 11, with_ctx=True)
    max_norm = float(raw["grad_norm"]) / 2.0
    jp, _, jm = jax_run(env, 11, with_ctx=True, max_grad_norm=max_norm, clip_mode=mode)
    p0, p1, _, m, _ = port_run(env, 11, with_ctx=True, max_grad_norm=max_norm, clip_mode=mode)
    assert np.isclose(float(m["grad_norm"]), float(raw["grad_norm"]), rtol=1e-5)
    _assert_grads(p0, p1, {n: p0[n] - jp[n] for n in p0})


def test_unknown_prediction_type_rejected(env):
    with pytest.raises(ValueError, match="prediction_type"):
        S.SchedulerConfig(**SCHED, prediction_type="nope")
    schedule = S.make_schedule(S.SchedulerConfig(**SCHED), device="cpu")
    object.__setattr__(schedule.config, "prediction_type", "nope")  # built by other means
    with torch.device("meta"):
        seg = SegmentedSDUNet(SDUNet(env["cfg"]))
    with pytest.raises(ValueError, match="prediction_type"):
        SegmentedSDTrainStep(seg, schedule, SGD())


def test_bf16_gradient_cache_close_to_exact(env):
    """``cache_dtype=torch.bfloat16``: the norm stays exact (taken before the
    cast), the update differs from the exact cache's by bf16 rounding of the
    cached gradients (the JAX test's bound, 5e-4 after an AdamW step at lr
    1e-3), and the port's bf16 step is that close to the JAX one."""
    opt_cfg = OptimizerConfig(learning_rate=1e-3, max_grad_norm=None, adam_weight_decay=1e-4)
    out = {}
    for name, dt in (("exact", None), ("bf16", torch.bfloat16)):
        _, p1, _, m, _ = port_run(env, 21, optimizer=Optimizer(opt_cfg), max_grad_norm=0.5,
                                  clip_mode="cache", cache_dtype=dt)
        out[name] = (torch.cat([t.reshape(-1) for t in p1.values()]), float(m["grad_norm"]))
    assert out["exact"][1] == out["bf16"][1]
    diff = (out["exact"][0] - out["bf16"][0]).abs().max()
    assert 0 < diff < 5e-4
    jp, _, _ = jax_run(env, 21, optimizer=optax.adamw(1e-3), max_grad_norm=0.5,
                       clip_mode="cache", cache_dtype=jnp.bfloat16)
    _, p1, _, _, _ = port_run(env, 21, optimizer=Optimizer(opt_cfg), max_grad_norm=0.5,
                              clip_mode="cache", cache_dtype=torch.bfloat16)
    assert max(float((p1[n] - jp[n]).abs().max()) for n in p1) < 5e-4
    with torch.device("meta"):
        seg = SegmentedSDUNet(SDUNet(env["cfg"]))
    with pytest.raises(ValueError, match="cache_dtype"):
        SegmentedSDTrainStep(seg, S.make_schedule(S.SchedulerConfig(**SCHED), device="cpu"),
                             SGD(), max_grad_norm=0.5, clip_mode="recompute",
                             cache_dtype=torch.bfloat16)
