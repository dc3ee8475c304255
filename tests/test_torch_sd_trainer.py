"""The port's ``for_sd_pipeline`` and the trainer's remaining options, on
the CPU.

Ports of the SD cases of ``tests/test_trainer.py``, run through the port's
own ``for_sd_pipeline`` on a tiny SD pipeline (the configs of
``tests/test_torch_sd_pipeline.py``) over the tiny 32 px image folder of
``conftest.py``: what trains and what stays bit-equal for each
``components_to_train``, attention fine-tuning, the argument checks, the
EMA save, and evaluation sampling from the EMA weights.  The eval cadence
(``eval_every_opti_steps``, ``precise_first_n_epochs``) and the metrics'
reference set (``compute_metrics_full_dataset``) follow the JAX trainer's
loop.
"""

import numpy as np
import pytest
import torch

from phendiff_tpu_torch.core.scheduler import SchedulerConfig
from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKLConfig
from phendiff_tpu_torch.models.sd_unet import SDUNetConfig
from phendiff_tpu_torch.pipelines.sd_img2img import SDImg2ImgPipeline
from phendiff_tpu_torch.train.train_loop import OptimizerConfig, TrainConfig
from phendiff_tpu_torch.train.trainer import (
    _ATTENTION_MODULE_RE,
    RunPaths,
    TrainerConfig,
    build_data,
    for_sd_pipeline,
)

torch.set_num_threads(1)

TINY_SD = SDUNetConfig(
    sample_size=4, block_out_channels=(16, 32),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, cross_attention_dim=16, attention_head_dim=(2, 4), norm_num_groups=4,
)
TINY_VAE = AutoencoderKLConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                               norm_num_groups=4, latent_channels=4, sample_size=32)
SCHED = SchedulerConfig(num_train_timesteps=20, clip_sample=False)


def tiny_pipe():
    return SDImg2ImgPipeline.init_random(TINY_SD, TINY_VAE, SCHED, num_classes=2,
                                         class_embedding_dim=16, seed=0, device="cpu")


def make_config(data_dir, **overrides):
    base = dict(
        train_data_dir=str(data_dir), definition=(32, 32), train_batch_size=8, num_epochs=1,
        eval_every_epochs=None, checkpointing_steps=1000, mixed_precision="no",
        compute_metrics=False,
        train=TrainConfig(optimizer=OptimizerConfig(learning_rate=1e-3)),
    )
    base.update(overrides)
    return TrainerConfig(**base)


def snapshot(pipe):
    return {f"{prefix}.{n}": p.detach().clone()
            for prefix, m in (("unet", pipe.unet), ("class_embedding", pipe.class_embedding),
                              ("vae", pipe.vae))
            for n, p in m.named_parameters()}


def moved(state, before, prefix):
    """Whether any of the trained tensors under ``prefix`` differs from its
    start."""
    return any(not torch.equal(p.detach(), before[n]) for n, p in state.params.items()
               if n.startswith(prefix))


def test_sd_finetune_frozen_vae(tiny_image_root, tmp_path):
    pipe = tiny_pipe()
    before = snapshot(pipe)
    trainer = for_sd_pipeline(pipe, make_config(tiny_image_root),
                              RunPaths.create(str(tmp_path), "exp", "run"))
    assert not any(n.startswith("vae.") for n in trainer.state.params)
    state = trainer.run()
    assert state.step == 4  # 32 images, batch 8, one epoch
    assert moved(state, before, "unet.") and moved(state, before, "class_embedding.")
    for n, p in pipe.vae.named_parameters():  # the frozen VAE is untouched
        assert torch.equal(p, before[f"vae.{n}"]), n


def test_sd_finetune_class_embedding_only(tiny_image_root, tmp_path):
    pipe = tiny_pipe()
    before = snapshot(pipe)
    trainer = for_sd_pipeline(pipe, make_config(tiny_image_root),
                              RunPaths.create(str(tmp_path), "exp", "run"),
                              components_to_train=("class_embedding",))
    state = trainer.run()
    assert not moved(state, before, "unet.")
    assert moved(state, before, "class_embedding.")


def test_sd_attention_fine_tuning_trains_only_attention(tiny_image_root, tmp_path):
    """Exactly the Transformer2D parameters change; every other UNet
    parameter and the class embedding stay bit-equal."""
    pipe = tiny_pipe()
    before = snapshot(pipe)
    trainer = for_sd_pipeline(pipe, make_config(tiny_image_root),
                              RunPaths.create(str(tmp_path), "exp", "run"),
                              components_to_train=("denoiser",), attention_fine_tuning=True)
    state = trainer.run()
    n_attn = 0
    for n, p in state.params.items():
        parts = n.split(".")
        if parts[0] == "unet" and any(_ATTENTION_MODULE_RE.match(x) for x in parts[1:-1]):
            n_attn += 1
            assert not torch.equal(p.detach(), before[n]), f"attention parameter frozen: {n}"
        else:
            assert torch.equal(p.detach(), before[n]), n
    assert n_attn > 0


def test_sd_attention_fine_tuning_requires_denoiser(tiny_image_root, tmp_path):
    with pytest.raises(ValueError, match="denoiser"):
        for_sd_pipeline(tiny_pipe(), make_config(tiny_image_root),
                        RunPaths.create(str(tmp_path), "exp", "run"),
                        components_to_train=("class_embedding",), attention_fine_tuning=True)


def test_sd_finetune_trains_vae_encoder(tiny_image_root, tmp_path):
    """'autoencoder' trains the VAE through the loss: encoder and quant_conv
    move, decoder and post_quant_conv stay bit-equal; the saved pipeline
    carries the EMA VAE."""
    pipe = tiny_pipe()
    before = snapshot(pipe)
    paths = RunPaths.create(str(tmp_path), "exp", "run")
    trainer = for_sd_pipeline(pipe, make_config(tiny_image_root), paths,
                              components_to_train=("denoiser", "class_embedding", "autoencoder"))
    state = trainer.run()
    for mod in ("encoder", "quant_conv"):
        assert moved(state, before, f"vae.{mod}."), mod
    for mod in ("decoder", "post_quant_conv"):
        assert not moved(state, before, f"vae.{mod}."), mod
    trainer.save_pipeline_fn(state, paths.full_pipeline_save)
    reloaded = SDImg2ImgPipeline.from_pretrained(paths.full_pipeline_save, device="cpu")
    for n, p in reloaded.vae.named_parameters():
        assert torch.equal(p, state.ema_params[f"vae.{n}"]), n


def test_sd_rejects_unknown_component(tiny_image_root, tmp_path):
    with pytest.raises(ValueError, match="unknown components_to_train"):
        for_sd_pipeline(tiny_pipe(), make_config(tiny_image_root),
                        RunPaths.create(str(tmp_path), "exp", "run"),
                        components_to_train=("vae",))


def test_sd_ema_save_reloads_and_eval_samples_from_the_ema(tiny_image_root, tmp_path):
    """The end-of-epoch eval saves the EMA weights as an ``SDImg2ImgPipeline``
    folder that ``from_pretrained`` reloads; the eval's generate function
    samples from the EMA weights as the pipeline's own ``generate`` does."""
    pipe = tiny_pipe()
    paths = RunPaths.create(str(tmp_path), "exp", "run")
    trainer = for_sd_pipeline(pipe, make_config(tiny_image_root, eval_every_epochs=1,
                                                max_train_steps=2), paths)
    state = trainer.run()
    reloaded = SDImg2ImgPipeline.from_pretrained(paths.full_pipeline_save, device="cpu")
    for prefix, module in (("unet", reloaded.unet), ("class_embedding",
                                                       reloaded.class_embedding)):
        for n, p in module.named_parameters():
            assert torch.equal(p, state.ema_params[f"{prefix}.{n}"]), n
    for n, p in reloaded.vae.named_parameters():  # the frozen VAE, saved as it was
        assert torch.equal(p, dict(pipe.vae.named_parameters())[n]), n

    labels = torch.tensor([0, 1])
    got = trainer.make_generate_fn(state)(labels, torch.Generator().manual_seed(3), 2)
    want = reloaded.generate(labels, torch.Generator().manual_seed(3), num_inference_steps=2)
    assert got.shape == (2, 32, 32, 3) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_eval_cadence_matches_the_jax_loop(tiny_image_root, tmp_path, monkeypatch):
    """``eval_every_opti_steps`` evaluates inside an epoch and
    ``precise_first_n_epochs`` at the end of each early epoch, beside
    ``eval_every_epochs``, in the JAX trainer's order."""
    trainer = for_sd_pipeline(
        tiny_pipe(), make_config(tiny_image_root, num_epochs=3, eval_every_opti_steps=3,
                                 precise_first_n_epochs=1, eval_every_epochs=2),
        RunPaths.create(str(tmp_path), "exp", "run"))
    evals = []
    monkeypatch.setattr(trainer, "_run_eval", evals.append)
    trainer.run()
    # 4 steps an epoch: steps 3, 6, 9, 12; epoch 0 (precise) and epoch 1 (every 2)
    assert evals == [3, 4, 6, 8, 9, 12]


@pytest.mark.parametrize("full", [True, False])
def test_compute_metrics_full_dataset(tiny_image_root, full):
    index, loader, eval_index = build_data(make_config(
        tiny_image_root, perc_samples=50, compute_metrics_full_dataset=full, loader_prefetch=1))
    assert len(index) == 16 and loader.config.prefetch == 1
    assert len(eval_index) == (32 if full else 16)
    assert np.array_equal(np.bincount(eval_index.labels), [len(eval_index) // 2] * 2)
