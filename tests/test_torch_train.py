"""The port's training step against the JAX package's ``make_train_step``.

Same Flax parameters (converted by ``from_flax_params``), the same numpy
images, and the JAX step's own random draws (its key splits, reproduced
here and injected as ``StepDraws``), f32 on the CPU, on a tiny UNet with
one ``AttnDownBlock2D`` so attention is on the gradient path.

Tolerances.  Loss and gradient norm: rtol 1e-5 (f32 rounding of the same
sums in another order).  Parameters and EMA after one and three steps:
atol 1e-6, 1% of one update at lr 1e-4, so a skipped or doubled step
fails.  These steps run with ``adam_epsilon=1e-3``.  With the default 1e-8,
Adam turns an element whose gradient is at f32 rounding noise (~1e-9; the
key third of each ``qkv.bias`` has an exact gradient of zero, since it
shifts a whole row of scores) into a sign-like update of order lr that
differs between any two summation orders.  With 1e-3 such elements move by
~1e-10, while typical gradients here (~1e-2) still move their elements by
~0.9 lr.  ``test_optimizer_matches_optax`` covers the default epsilon.
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
from phendiff_tpu.core import scheduler as jax_sched  # noqa: E402
from phendiff_tpu.models import CondUNet2D as JaxUNet  # noqa: E402
from phendiff_tpu.models import UNet2DConfig as JaxConfig  # noqa: E402
from phendiff_tpu.pipelines.io import flatten_params  # noqa: E402
from phendiff_tpu.train import ema as jax_ema  # noqa: E402
from phendiff_tpu.train import train_loop as JT  # noqa: E402
from phendiff_tpu.train.trainer import attention_param_mask as jax_attention_mask  # noqa: E402
from phendiff_tpu_torch.core import scheduler as S  # noqa: E402
from phendiff_tpu_torch.models import convert  # noqa: E402
from phendiff_tpu_torch.models.config import UNet2DConfig  # noqa: E402
from phendiff_tpu_torch.models.unet2d import CondUNet2D  # noqa: E402
from phendiff_tpu_torch.train import ema as E  # noqa: E402
from phendiff_tpu_torch.train import train_loop as T  # noqa: E402
from phendiff_tpu_torch.train.trainer import attention_param_mask  # noqa: E402

torch.set_num_threads(1)

TINY = dict(
    sample_size=8, block_out_channels=(8, 16),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1, norm_num_groups=4, attention_head_dim=4, num_class_embeds=2,
)
T_STEPS = 50
LR = 1e-4
PARAM_ATOL = 1e-6
LOSS_RTOL = 1e-5
SCHEDULES = ("constant", "constant_with_warmup", "linear", "cosine", "polynomial")


@pytest.fixture(scope="module")
def flax_model():
    model = JaxUNet(JaxConfig(**TINY), lane_pack=False)
    params = model.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)), jnp.array([0]),
                        class_labels=jnp.array([0]))
    return model, params


def _to_torch(tree):
    return convert.from_flax_params(flatten_params(tree), UNet2DConfig(**TINY))


def _jax_draws(key, step, shape, proba_uncond):
    """The draws of the JAX step: fold_in(key, step) -> (flip, enc, loss);
    loss -> (noise, t)."""
    k_flip, _, k_loss = jax.random.split(jax.random.fold_in(key, step), 3)
    k_noise, k_t = jax.random.split(k_loss)
    return T.StepDraws(
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, shape, jnp.float32))),
        timesteps=torch.from_numpy(np.array(jax.random.randint(k_t, (shape[0],), 0, T_STEPS))),
        uncond=bool(jax.random.bernoulli(k_flip, proba_uncond)) if proba_uncond > 0 else False,
    )


def _assert_close_params(got, want, what):
    for n, w in want.items():
        np.testing.assert_allclose(got[n].detach().numpy(), w.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"{what} {n}")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pt", ["epsilon", "sample", "v_prediction"])
def test_train_steps_match_jax(flax_model, pt, masked):
    jmodel, params = flax_model
    sched_kw = dict(num_train_timesteps=T_STEPS, prediction_type=pt)
    proba_uncond = 0.5
    # masked runs also cover a warmup schedule: the first update uses lr 0
    opt_kw = dict(learning_rate=LR, lr_scheduler="cosine" if masked else "constant",
                  lr_warmup_steps=2, total_steps=10, adam_epsilon=1e-3)
    jcfg = JT.TrainConfig(proba_uncond=proba_uncond, optimizer=JT.OptimizerConfig(**opt_kw))
    jopt = JT.make_optimizer(jcfg.optimizer, jax_attention_mask if masked else None)
    jstep = jax.jit(JT.make_train_step(
        lambda p, x, t, ce: jmodel.apply(p, x, t, class_emb=ce),
        lambda p, lab: p["params"]["class_embedding"]["embedding"][lab],
        jax_make_schedule(JaxSchedulerConfig(**sched_kw)), jcfg, jopt))
    jstate = JT.init_train_state(params, jopt)

    cfg = UNet2DConfig(**TINY)
    with torch.device("meta"):
        tmodel = CondUNet2D(cfg)
    tparams = {n: v.requires_grad_() for n, v in _to_torch(params).items()}
    tcfg = T.TrainConfig(proba_uncond=proba_uncond, optimizer=T.OptimizerConfig(**opt_kw))
    topt = T.make_optimizer(tcfg.optimizer, attention_param_mask if masked else None)
    tstep = T.make_train_step(
        lambda p, x, t, ce: functional_call(tmodel, p, (x, t), {"class_emb": ce}),
        lambda p, lab: p["class_embedding.weight"][lab],
        S.make_schedule(S.SchedulerConfig(**sched_kw), device="cpu"), tcfg, topt)
    tstate = T.init_train_state(tparams, topt)

    rng = np.random.default_rng(1)
    images = rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32)
    labels = np.array([0, 1, 1, 0], dtype=np.int32)
    key = jax.random.key(7)
    tbatch = (torch.from_numpy(images), torch.from_numpy(labels).long())
    for step in range(3):
        jstate, jm = jstep(jstate, (jnp.asarray(images), jnp.asarray(labels)), key)
        tstate, tm = tstep(tstate, tbatch, _jax_draws(key, step, images.shape, proba_uncond))
        assert tstate.step == int(jstate.step) == step + 1
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        assert int(tm["nonfinite"]) == int(jm["nonfinite"]) == 0
        if step in (0, 2):
            _assert_close_params(tstate.params, _to_torch(jstate.params), f"step {step + 1}")
            _assert_close_params(tstate.ema_params, _to_torch(jstate.ema_params),
                                 f"ema step {step + 1}")
    if masked:  # frozen parameters did not move, trained ones did
        mask = attention_param_mask(tparams)
        assert any(mask.values()) and not all(mask.values())
        for n, p in tstate.params.items():
            assert torch.equal(p.detach(), tparams[n].detach()) != mask[n], n


@pytest.mark.parametrize("name", SCHEDULES)
def test_lr_schedules_match_optax(name):
    kw = dict(learning_rate=3e-4, lr_scheduler=name, lr_warmup_steps=5, total_steps=40,
              lr_scale=2.0)
    want = JT.make_lr_schedule(JT.OptimizerConfig(**kw))
    got = T.make_lr_schedule(T.OptimizerConfig(**kw))
    for count in [0, 1, 2, 4, 5, 6, 17, 39, 40, 41, 1000]:
        # atol: optax evaluates 1 + cos(.) in f32, which cancels near the end
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-9,
                                   err_msg=f"{name} at {count}")


@pytest.mark.parametrize("clipped,masked", [(False, False), (True, False), (True, True)])
def test_optimizer_matches_optax(clipped, masked):
    """Three updates of clip + AdamW (+ multi_transform) on random tensors."""
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    mask = {"a": True, "b": False, "c": True} if masked else None  # optax takes the tree
    cfg_kw = dict(learning_rate=1e-2, max_grad_norm=0.5 if clipped else 1e3,
                  lr_scheduler="linear", lr_warmup_steps=1, total_steps=5)
    jopt = JT.make_optimizer(JT.OptimizerConfig(**cfg_kw), mask)
    jparams = {n: jnp.asarray(v) for n, v in params.items()}
    jstate = jopt.init(jparams)
    topt = T.make_optimizer(T.OptimizerConfig(**cfg_kw), (lambda p: mask) if masked else None)
    tparams = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    tstate = topt.init(tparams)
    for _ in range(3):
        grads = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
        upd, jstate = jopt.update({n: jnp.asarray(g) for n, g in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        topt.update({n: torch.from_numpy(g) for n, g in grads.items()}, tstate, tparams)
    for n in shapes:  # f32 rounding of p + u over three steps; one update is ~1e-2
        np.testing.assert_allclose(tparams[n].numpy(), np.asarray(jparams[n]), rtol=1e-6,
                                   atol=1e-7)
    assert tstate.count == 3
    if masked:
        np.testing.assert_array_equal(tparams["b"].numpy(), params["b"])


def _optax_mu(jstate):
    """The first moments in an optax state (chain or multi_transform)."""
    return optax.tree_utils.tree_get(jstate, "mu")


@pytest.mark.parametrize("chunk", [None, 16])
@pytest.mark.parametrize("clipped,masked", [(False, False), (True, False), (True, True)])
def test_bf16_moment_optimizer_matches_optax(clipped, masked, chunk, monkeypatch):
    """Three updates with ``moment_dtype="bfloat16"`` against optax's
    ``mu_dtype=bfloat16``, whole and in chunks of 16 elements.  Parameters
    to the f32 test's tolerance (the update reads the same f32 moment).
    The stored bf16 moment: unclipped, bit equal to optax's (the same
    roundings: b1 * mu in bf16, the sum in f32, then to bf16); clipped,
    within one bf16 ulp, since the clip factor comes from a norm summed in
    another order, and a gradient one f32 ulp away can round the moment to
    the other bf16 neighbour (about one element in 65536; that element's
    next update then moves by ~0.4% of lr)."""
    if chunk is not None:
        monkeypatch.setattr(T, "UPDATE_CHUNK", chunk)
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    mask = {"a": True, "b": False, "c": True} if masked else None
    cfg_kw = dict(learning_rate=1e-2, max_grad_norm=0.5 if clipped else 1e3,
                  lr_scheduler="linear", lr_warmup_steps=1, total_steps=5,
                  moment_dtype="bfloat16")
    jopt = JT.make_optimizer(JT.OptimizerConfig(**cfg_kw), mask)
    jparams = {n: jnp.asarray(v) for n, v in params.items()}
    jstate = jopt.init(jparams)
    topt = T.make_optimizer(T.OptimizerConfig(**cfg_kw), (lambda p: mask) if masked else None)
    tparams = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    tstate = topt.init(tparams)
    assert {t.dtype for t in tstate.mu.values()} == {torch.bfloat16}
    assert {t.dtype for t in tstate.nu.values()} == {torch.float32}
    for _ in range(3):
        grads = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
        upd, jstate = jopt.update({n: jnp.asarray(g) for n, g in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        topt.update({n: torch.from_numpy(g) for n, g in grads.items()}, tstate, tparams)
    for n in shapes:
        np.testing.assert_allclose(tparams[n].numpy(), np.asarray(jparams[n]), rtol=1e-6,
                                   atol=1e-7)
    jmu = _optax_mu(jstate)
    for n, mu in tstate.mu.items():
        want = np.asarray(jmu[n].astype(jnp.float32))
        assert jmu[n].dtype == jnp.bfloat16
        if not clipped:
            np.testing.assert_array_equal(mu.float().numpy(), want, err_msg=n)
        ulp = np.spacing(np.abs(want).astype(jnp.bfloat16)).astype(np.float32)
        assert np.all(np.abs(mu.float().numpy() - want) <= ulp), n
    assert tstate.count == 3
    if masked:
        np.testing.assert_array_equal(tparams["b"].numpy(), params["b"])
        assert set(tstate.mu) == {"a", "c"}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_update_in_chunks_equals_one_chunk(moment_dtype, monkeypatch):
    """The chunked update is the same arithmetic element for element: bit
    equal to one chunk, for chunks of one tensor and of several."""
    rng = np.random.default_rng(6)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2), "d": (7,)}
    cfg = T.OptimizerConfig(learning_rate=1e-2, max_grad_norm=0.5, moment_dtype=moment_dtype)
    params = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for n, s in shapes.items()}
    grads = [{n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for n, s in shapes.items()} for _ in range(3)]
    runs = []
    for chunk in (1 << 30, 13, 1):
        monkeypatch.setattr(T, "UPDATE_CHUNK", chunk)
        opt = T.make_optimizer(cfg)
        p = {n: t.clone() for n, t in params.items()}
        state = opt.init(p)
        for g in grads:
            opt.update(g, state, p)
        runs.append((p, state))
    for p, state in runs[1:]:
        for n in shapes:
            for got, want in ((p, runs[0][0]), (state.mu, runs[0][1].mu),
                              (state.nu, runs[0][1].nu)):
                assert torch.equal(got[n], want[n]), n


def test_moment_dtype_is_checked():
    with pytest.raises(ValueError, match="moment_dtype"):
        T.OptimizerConfig(moment_dtype="float16")


def test_bf16_moment_state_resumes_bit_equal_and_refuses_another_dtype(tmp_path):
    """A bf16-moment TrainState saved and restored through the checkpoint
    manager is bit equal, moments in bf16; loading it into an f32-moment
    state (or the reverse) raises and leaves the state as it was."""
    from phendiff_tpu_torch.train.checkpoints import CheckpointManager

    rng = np.random.default_rng(7)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for n, s in shapes.items()}
    bf16 = T.make_optimizer(T.OptimizerConfig(learning_rate=1e-2, moment_dtype="bfloat16"))
    state = T.init_train_state(params, bf16)
    for _ in range(2):
        g = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for n, s in shapes.items()}
        bf16.update(g, state.opt_state, state.params)
        state.step += 1
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(2, state)
    fresh = T.init_train_state(params, bf16)
    ckpt.restore(fresh)
    assert fresh.step == 2 and fresh.opt_state.count == 2
    for mine, theirs in ((fresh.params, state.params), (fresh.ema_params, state.ema_params),
                         (fresh.opt_state.mu, state.opt_state.mu),
                         (fresh.opt_state.nu, state.opt_state.nu)):
        for n in shapes:
            assert mine[n].dtype == theirs[n].dtype and torch.equal(mine[n], theirs[n]), n
    assert {t.dtype for t in fresh.opt_state.mu.values()} == {torch.bfloat16}
    f32 = T.init_train_state(params, T.make_optimizer(T.OptimizerConfig()))
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.restore(f32)
    assert f32.step == 0 and all(not t.any() for t in f32.opt_state.mu.values())
    with pytest.raises(ValueError, match="float32"):
        fresh.load_state_dict(f32.state_dict())


def test_ema_matches_jax():
    cfg = E.EMAConfig(inv_gamma=1.0, power=0.75, max_decay=0.9999)
    jcfg = jax_ema.EMAConfig(inv_gamma=1.0, power=0.75, max_decay=0.9999)
    for step in [0, 1, 10, 1000, 10**9]:
        np.testing.assert_allclose(E.ema_decay(cfg, step), float(jax_ema.ema_decay(jcfg, step)),
                                   rtol=1e-7)
    rng = np.random.default_rng(3)
    e, p = (rng.standard_normal((4, 5)).astype(np.float32) for _ in range(2))
    want = jax_ema.ema_update(jcfg, {"w": jnp.asarray(e)}, {"w": jnp.asarray(p)}, 7)["w"]
    got = {"w": torch.from_numpy(e.copy())}
    E.ema_update(cfg, got, {"w": torch.from_numpy(p)}, 7)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want), atol=1e-7)


@pytest.mark.parametrize("beta_schedule", ["linear", "squaredcos_cap_v2"])
def test_velocity_and_snr_match_jax(beta_schedule):
    kw = dict(num_train_timesteps=100, beta_schedule=beta_schedule)
    js = jax_make_schedule(JaxSchedulerConfig(**kw))
    ts = S.make_schedule(S.SchedulerConfig(**kw), device="cpu")
    rng = np.random.default_rng(4)
    x0, noise = (rng.standard_normal((3, 4, 4, 2)).astype(np.float32) for _ in range(2))
    t = np.array([0, 37, 99])
    want_v = jax_sched.velocity(js, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    got_v = S.velocity(ts, torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-6)
    np.testing.assert_allclose(S.snr(ts, torch.from_numpy(t)).numpy(),
                               np.asarray(jax_sched.snr(js, jnp.asarray(t))), rtol=1e-5)
    # add_noise, velocity and predict_x0_eps agree: v turns back into (x0, eps)
    xt = S.add_noise(ts, torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t))
    x0_back, eps_back = S.predict_x0_eps(ts, got_v, torch.from_numpy(t), xt, "v_prediction")
    np.testing.assert_allclose(x0_back.numpy(), x0, atol=1e-5)
    np.testing.assert_allclose(eps_back.numpy(), noise, atol=1e-5)


def test_make_draws_is_a_function_of_seed_and_step():
    a = T.make_draws(3, 5, (4, 8, 8, 3), T_STEPS, 0.5, "cpu")
    b = T.make_draws(3, 5, (4, 8, 8, 3), T_STEPS, 0.5, "cpu")
    c = T.make_draws(3, 6, (4, 8, 8, 3), T_STEPS, 0.5, "cpu")
    assert torch.equal(a.noise, b.noise) and torch.equal(a.timesteps, b.timesteps)
    assert a.uncond == b.uncond and not torch.equal(a.noise, c.noise)
    assert a.noise.shape == (4, 8, 8, 3) and a.timesteps.dtype == torch.int64
    assert int(a.timesteps.min()) >= 0 and int(a.timesteps.max()) < T_STEPS
    flips = [T.make_draws(0, s, (1, 1, 1, 1), T_STEPS, 0.1, "cpu").uncond for s in range(400)]
    assert 10 < sum(flips) < 70  # about 40 of 400
    assert not any(T.make_draws(0, s, (1, 1, 1, 1), T_STEPS, 0.0, "cpu").uncond
                   for s in range(50))
