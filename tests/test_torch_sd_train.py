"""The port's SD fine-tune step against the JAX package's, on the CPU.

A tiny JAX ``SDImg2ImgPipeline`` (the configs of
``tests/test_torch_sd_pipeline.py``) is saved by the JAX package and loaded
by the port.  Each side builds its ``Trainer`` with its own
``for_sd_pipeline`` over the tiny image folder of ``conftest.py`` (32 px,
latents 4 x 4), and one and three steps of each trainer's step function run
on the same numpy batch, f32.  The port gets the JAX step's own draws (its
``fold_in``/``split`` keys: ``k_flip`` the coin flip, ``k_enc`` the VAE
posterior's noise, ``k_loss`` the diffusion noise and timesteps) as
``StepDraws``, at the latent shape.

Tolerances, as ``tests/test_torch_train.py``: loss and gradient norm rtol
1e-5 (f32 sums in another order); parameters and EMA atol 1e-6 after one
and three steps, with ``adam_epsilon=1e-3`` (at 1e-8 Adam turns
rounding-noise gradients into O(lr) updates of either sign).  Remat
recomputes the same f32 operations on the CPU, so a step with it equals the
step without it exactly.
"""

import dataclasses
import os

os.environ["PHENDIFF_PALLAS_INTERPRET"] = "1"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from phendiff_tpu.core import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from phendiff_tpu.models.autoencoder_kl import AutoencoderKLConfig as JaxVAEConfig  # noqa: E402
from phendiff_tpu.models.sd_unet import SDUNetConfig as JaxSDConfig  # noqa: E402
from phendiff_tpu.pipelines.io import flatten_params  # noqa: E402
from phendiff_tpu.pipelines.sd_img2img import SDImg2ImgPipeline as JaxSDPipeline  # noqa: E402
from phendiff_tpu.train import train_loop as JT  # noqa: E402
from phendiff_tpu.train import trainer as jax_trainer  # noqa: E402
from phendiff_tpu_torch.models import convert  # noqa: E402
from phendiff_tpu_torch.models.config import UNet2DConfig  # noqa: E402
from phendiff_tpu_torch.models.unet2d import CondUNet2D  # noqa: E402
from phendiff_tpu_torch.pipelines.sd_img2img import SDImg2ImgPipeline  # noqa: E402
from phendiff_tpu_torch.train import train_loop as T  # noqa: E402
from phendiff_tpu_torch.train import trainer  # noqa: E402

torch.set_num_threads(1)

TINY_SD = dict(
    sample_size=4, block_out_channels=(16, 32),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, cross_attention_dim=16, attention_head_dim=(2, 4), norm_num_groups=4,
)
TINY_VAE = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4,
                latent_channels=4, sample_size=32)
T_STEPS = 50
SCHED = JaxSchedulerConfig(num_train_timesteps=T_STEPS, clip_sample=False)
PROBA_UNCOND = 0.5
OPT = dict(learning_rate=1e-4, adam_epsilon=1e-3)
PARAM_ATOL = 1e-6
LOSS_RTOL = 1e-5
TRAIN_VAE = ("denoiser", "class_embedding", "autoencoder")


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    root = tmp_path_factory.mktemp("sd_train")
    jpipe = JaxSDPipeline.init_random(JaxSDConfig(**TINY_SD), JaxVAEConfig(**TINY_VAE), SCHED,
                                      num_classes=2, class_embedding_dim=16, seed=0)
    jpipe.save_pretrained(str(root / "pipe"))
    return jpipe, str(root / "pipe"), root


def _batch():
    rng = np.random.default_rng(1)
    images = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    labels = np.array([0, 1, 1, 0], dtype=np.int32)
    return images, labels


def _jax_draws(key, step, latent_shape):
    """The draws of the JAX step: fold_in(key, step) -> (flip, enc, loss);
    loss -> (noise, t).  The posterior's noise has the latents' shape too."""
    k_flip, k_enc, k_loss = jax.random.split(jax.random.fold_in(key, step), 3)
    k_noise, k_t = jax.random.split(k_loss)
    arr = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return T.StepDraws(
        noise=arr(jax.random.normal(k_noise, latent_shape, jnp.float32)),
        timesteps=arr(jax.random.randint(k_t, (latent_shape[0],), 0, T_STEPS)),
        uncond=bool(jax.random.bernoulli(k_flip, PROBA_UNCOND)),
        enc_noise=arr(jax.random.normal(k_enc, latent_shape, jnp.float32)),
    )


def _to_port_names(jparams, tpipe):
    """The JAX trainer's param tree as the port's flat ``unet.*`` /
    ``class_embedding.*`` / ``vae.*`` dict."""
    modules = {"unet": tpipe.unet, "class_embedding": tpipe.class_embedding,
               "vae": tpipe.vae}
    out = {}
    for comp, tree in jparams.items():
        flat = convert.from_flax_params(flatten_params(tree), modules[comp])
        out.update({f"{comp}.{n}": torch.as_tensor(np.asarray(v)) for n, v in flat.items()})
    return out


def _assert_close(got, want, what):
    assert set(got) == set(want), what
    for n, w in want.items():
        np.testing.assert_allclose(got[n].detach().numpy(), w.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"{what} {n}")


def _configs(data_dir):
    train = dict(proba_uncond=PROBA_UNCOND)
    kw = dict(train_data_dir=str(data_dir), definition=(32, 32), train_batch_size=4,
              num_epochs=1, eval_every_epochs=None, mixed_precision="no",
              compute_metrics=False)
    jcfg = jax_trainer.TrainerConfig(
        **kw, train=JT.TrainConfig(**train, optimizer=JT.OptimizerConfig(**OPT)))
    tcfg = trainer.TrainerConfig(
        **kw, train=T.TrainConfig(**train, optimizer=T.OptimizerConfig(**OPT)))
    return jcfg, tcfg


@pytest.mark.parametrize("components", [("denoiser", "class_embedding"), TRAIN_VAE],
                         ids=["frozen_vae", "vae_encoder_trained"])
def test_sd_train_steps_match_jax(pipes, tiny_image_root, components):
    jpipe, folder, root = pipes
    jcfg, tcfg = _configs(tiny_image_root)
    name = "_".join(components)
    jtr = jax_trainer.for_sd_pipeline(
        jpipe, jcfg, jax_trainer.RunPaths.create(str(root), "jax", name),
        components_to_train=components, devices=jax.devices()[:1])
    tpipe = SDImg2ImgPipeline.from_pretrained(folder, device="cpu")
    ttr = trainer.for_sd_pipeline(tpipe, tcfg, trainer.RunPaths.create(str(root), "port", name),
                                  components_to_train=components)
    assert ttr.state.opt_state.mu.keys() == {
        n for n, on in ttr.optimizer.trainable_mask(ttr.state.params).items() if on}

    images, labels = _batch()
    latent_shape = ttr.diffusion_shape(images.shape)
    assert latent_shape == (4, 4, 4, 4)
    key = jax.random.key(7)
    jstate, tstate = jtr.state, ttr.state
    tbatch = (torch.from_numpy(images), torch.from_numpy(labels).long())
    for step in range(3):
        jstate, jm = jtr._step_fn(jstate, (jnp.asarray(images), jnp.asarray(labels)), key)
        tstate, tm = ttr._step_fn(tstate, tbatch, _jax_draws(key, step, latent_shape))
        assert tstate.step == int(jstate.step) == step + 1
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=LOSS_RTOL)
        assert int(tm["nonfinite"]) == int(jm["nonfinite"]) == 0
        if step in (0, 2):
            _assert_close(tstate.params, _to_port_names(jstate.params, tpipe),
                          f"step {step + 1}")
            _assert_close(tstate.ema_params, _to_port_names(jstate.ema_params, tpipe),
                          f"ema step {step + 1}")
    if "autoencoder" in components:  # the encoder trained, the decoder did not
        before = dict(tpipe.vae.named_parameters())
        for n, p in tstate.params.items():
            if n.startswith("vae."):
                moved = not torch.equal(p.detach(), before[n[4:]].detach())
                assert moved == (n.split(".")[1] in ("encoder", "quant_conv")), n


def _remat_step(family, remat, tpipe=None):
    """One step of the SD trainer's (or a tiny DDIM's) step function, with
    or without remat, from the same parameters and draws."""
    images, labels = _batch()
    batch = (torch.from_numpy(images), torch.from_numpy(labels).long())
    cfg = T.TrainConfig(proba_uncond=0.0, optimizer=T.OptimizerConfig(**OPT))
    if family == "sd":
        kw = trainer.sd_trainer_kwargs(
            tpipe, trainer.TrainerConfig(mixed_precision="no", remat=remat, train=cfg),
            TRAIN_VAE)
        opt = T.make_optimizer(cfg.optimizer, kw["trainable_mask"])
        step = T.make_train_step(kw["model_apply"], kw["embed_fn"], kw["schedule"], cfg, opt,
                                 kw["encode_fn"], kw["encode_inside_grad"])
        params, shape = kw["trainable_params"], kw["diffusion_shape"](images.shape)
    else:
        ucfg = UNet2DConfig(sample_size=32, block_out_channels=(8, 16),
                            down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                            up_block_types=("AttnUpBlock2D", "UpBlock2D"), layers_per_block=1,
                            norm_num_groups=4, attention_head_dim=4, num_class_embeds=2)
        real = CondUNet2D(ucfg).init_weights(torch.Generator().manual_seed(0))
        with torch.device("meta"):
            model = CondUNet2D(ucfg, remat=remat)
        opt = T.make_optimizer(cfg.optimizer)
        step = T.make_train_step(
            lambda p, x, t, ce: torch.func.functional_call(model, p, (x, t), {"class_emb": ce}),
            lambda p, lab: p["class_embedding.weight"][lab],
            T.S.make_schedule(T.S.SchedulerConfig(num_train_timesteps=T_STEPS), device="cpu"),
            cfg, opt)
        params, shape = real, images.shape
    state = T.init_train_state(params, opt)
    draws = T.make_draws(3, 0, shape, T_STEPS, 0.0, "cpu", posterior=family == "sd")
    state, m = step(state, batch, draws)
    return state, m


@pytest.mark.parametrize("family", ["sd", "ddim"])
def test_remat_gives_the_same_step(pipes, family):
    tpipe = SDImg2ImgPipeline.from_pretrained(pipes[1], device="cpu") if family == "sd" else None
    plain_state, plain_m = _remat_step(family, False, tpipe)
    remat_state, remat_m = _remat_step(family, True, tpipe)
    torch.testing.assert_close(remat_m["loss"], plain_m["loss"], rtol=0, atol=0)
    torch.testing.assert_close(remat_m["grad_norm"], plain_m["grad_norm"], rtol=0, atol=0)
    assert remat_state.params.keys() == plain_state.params.keys()
    for n, p in plain_state.params.items():
        torch.testing.assert_close(remat_state.params[n], p, rtol=0, atol=0, msg=n)
    assert any(not torch.equal(p.detach(), q.detach())  # the step moved something
               for p, q in zip(plain_state.params.values(), plain_state.ema_params.values()))


def test_noise_follows_the_clean_tensors_dtype():
    """The diffusion noise is cast to the clean tensor's dtype, as the JAX
    step draws it in that dtype: bf16 latents give a bf16 noisy input and a
    bf16 noise target."""
    seen = {}

    def model_apply(p, x, t, emb):
        seen["x"] = x.dtype
        return x * p["w"]

    schedule = T.S.make_schedule(T.S.SchedulerConfig(num_train_timesteps=T_STEPS), device="cpu")
    cfg = T.TrainConfig()
    opt = T.make_optimizer(cfg.optimizer)
    step = T.make_train_step(model_apply, lambda p, lab: p["e"][lab], schedule, cfg, opt,
                             encode_fn=lambda images, draws: images.to(torch.bfloat16))
    state = T.init_train_state({"w": torch.ones(()).requires_grad_(),
                                "e": torch.zeros(2, 3).requires_grad_()}, opt)
    draws = T.make_draws(0, 0, (2, 4, 4, 3), T_STEPS, 0.0, "cpu", posterior=True)
    assert draws.noise.dtype == draws.enc_noise.dtype == torch.float32
    state, m = step(state, (torch.rand(2, 4, 4, 3), torch.tensor([0, 1])), draws)
    assert seen["x"] == torch.bfloat16 and bool(torch.isfinite(m["loss"]))
    clean = torch.rand(2, 4, 4, 3).to(torch.bfloat16)
    for pt in ("epsilon", "v_prediction"):
        sch = T.S.make_schedule(T.S.SchedulerConfig(num_train_timesteps=T_STEPS,
                                                    prediction_type=pt), device="cpu")
        T.diffusion_loss(model_apply, {"w": torch.ones(())}, sch, clean, None, draws.noise,
                         draws.timesteps)
        assert seen["x"] == torch.bfloat16, pt


def test_make_draws_posterior_noise():
    """The posterior's noise comes from a third derived seed: fixed by (seed,
    step), apart from the diffusion noise, and absent unless asked for."""
    a = T.make_draws(5, 2, (2, 4, 4, 4), T_STEPS, 0.1, "cpu", posterior=True)
    b = T.make_draws(5, 2, (2, 4, 4, 4), T_STEPS, 0.1, "cpu", posterior=True)
    c = T.make_draws(5, 2, (2, 4, 4, 4), T_STEPS, 0.1, "cpu")
    assert torch.equal(a.enc_noise, b.enc_noise) and a.enc_noise.shape == (2, 4, 4, 4)
    assert not torch.equal(a.enc_noise, a.noise) and c.enc_noise is None
    assert torch.equal(a.noise, c.noise) and torch.equal(a.timesteps, c.timesteps)
    assert dataclasses.replace(c, enc_noise=a.enc_noise).uncond == a.uncond
