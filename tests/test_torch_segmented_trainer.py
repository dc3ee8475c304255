"""The port's ``SegmentedSDTrainer`` on the CPU, case for case with
``tests/test_segmented_trainer.py``: a run that clips and checkpoints, the
exact resume, the denoiser-only freeze, the eval with the best-model save
and its reload, and attention fine-tuning.

That file's tiny SD and VAE configs on the 2 x 16-image folder of
``conftest.py`` read at 16 px (latents 4 x 4), f32.  The step itself is
held against the JAX step in ``tests/test_torch_segmented_train.py``; here
the run loop around it: what trains, what stays bit-equal, what the
checkpoint restores, and that eval sampling through the stages equals
sampling through the monolith with the same EMA weights.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.func import functional_call

from phendiff_tpu_torch.core.scheduler import SchedulerConfig
from phendiff_tpu_torch.metrics.fidelity import MetricsConfig
from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKLConfig, decode_from_latents
from phendiff_tpu_torch.models.embeddings import pad_to_clip_sequence
from phendiff_tpu_torch.models.sd_unet import SDUNet, SDUNetConfig
from phendiff_tpu_torch.pipelines.conditional_ddim import GuidanceConfig, ddim_sample
from phendiff_tpu_torch.pipelines.sd_img2img import SDImg2ImgPipeline
from phendiff_tpu_torch.train.eval_loop import EvalConfig
from phendiff_tpu_torch.train.segmented_trainer import SegmentedSDTrainer
from phendiff_tpu_torch.train.train_loop import OptimizerConfig, TrainConfig
from phendiff_tpu_torch.train.trainer import _ATTENTION_MODULE_RE, RunPaths, TrainerConfig

torch.set_num_threads(1)

TINY_SD = SDUNetConfig(
    sample_size=4, block_out_channels=(16, 32),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, cross_attention_dim=16, attention_head_dim=(2, 4), norm_num_groups=4,
)
TINY_VAE = AutoencoderKLConfig(block_out_channels=(8, 16, 16), layers_per_block=1,
                               norm_num_groups=4, latent_channels=4, sample_size=16)
SCHED = SchedulerConfig(num_train_timesteps=20, clip_sample=False)
TABLE = "class_embedding.embedding.weight"


def make_pipe():
    return SDImg2ImgPipeline.init_random(TINY_SD, TINY_VAE, SCHED, num_classes=2,
                                         class_embedding_dim=16, seed=0, device="cpu")


def make_config(data_dir, **overrides):
    base = dict(
        train_data_dir=str(data_dir), definition=(16, 16), train_batch_size=8, num_epochs=1,
        eval_every_epochs=None, checkpointing_steps=2, mixed_precision="no",
        compute_metrics=False,
        train=TrainConfig(proba_uncond=0.1,
                          optimizer=OptimizerConfig(learning_rate=1e-3, total_steps=50)),
        eval=EvalConfig(nb_generated_images=4, eval_batch_size=4, num_inference_steps=2,
                        metrics=MetricsConfig(fid=True, isc=False, kid=False)),
        tracker="jsonl",
    )
    base.update(overrides)
    return TrainerConfig(**base)


@pytest.fixture
def paths(tmp_path):
    return RunPaths.create(str(tmp_path), "exp", "segrun")


def test_training_runs_clips_and_checkpoints(tiny_image_root, paths):
    pipe = make_pipe()
    ce_before = pipe.class_embedding.embedding.weight.detach().clone()
    unet_before = {n: p.detach().clone() for n, p in pipe.unet.named_parameters()}
    trainer = SegmentedSDTrainer(pipe, make_config(tiny_image_root), paths)
    assert trainer.step_fn.max_grad_norm == 1.0  # the reference's default clip
    assert trainer.optimizer.cfg.max_grad_norm is None  # per-leaf AdamW
    state = trainer.run()
    assert state.step == 4  # 32 images / batch 8, one epoch
    assert trainer.ckpt.latest_step() == 4
    with open(os.path.join(paths.run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    losses = [r for r in recs if "loss" in r]
    assert [r["step"] for r in losses] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and "grad_norm" in r and "perf/t_await_s" in r
               for r in losses)
    # the ctx stage trained the table; the pipeline kept its own weights
    assert not torch.equal(state.params[TABLE], ce_before)
    assert torch.equal(pipe.class_embedding.embedding.weight, ce_before)
    assert all(torch.equal(p, unet_before[n]) for n, p in pipe.unet.named_parameters())


def test_bf16_moment_option_keeps_f32_moments_as_the_jax_route(tiny_image_root, paths):
    """The JAX segmented trainer builds its per-stage optax.adamw without
    mu_dtype, so its first moments stay f32 whatever the option says."""
    cfg = make_config(tiny_image_root, train=TrainConfig(optimizer=OptimizerConfig(
        learning_rate=1e-3, total_steps=50, moment_dtype="bfloat16")))
    trainer = SegmentedSDTrainer(make_pipe(), cfg, paths)
    assert trainer.optimizer.cfg.moment_dtype == "float32"
    moments = [t for st in trainer.state.opt_state.values() for t in (*st.mu.values(),
                                                                      *st.nu.values())]
    assert moments and {t.dtype for t in moments} == {torch.float32}


def test_resume_restores_exact_state(tiny_image_root, paths):
    t1 = SegmentedSDTrainer(make_pipe(), make_config(tiny_image_root), paths)
    out1 = t1.run()
    snap = {k: {n: t.clone() for n, t in d.items()} for k, d in
            (("params", out1.params), ("ema", out1.ema_params))}
    opt1 = {k: (s.count, {n: t.clone() for n, t in s.mu.items()}) for k, s in
            out1.opt_state.items()}

    t2 = SegmentedSDTrainer(make_pipe(), make_config(
        tiny_image_root, num_epochs=2, resume_from_checkpoint="latest"), paths)
    assert all(t.is_meta for t in t2.state.params.values())  # nothing materialized
    assert t2.maybe_resume() == (1, 0)
    assert t2.state.step == 4
    for k, d in (("params", t2.state.params), ("ema", t2.state.ema_params)):
        assert list(d) == list(snap[k])
        for n, t in d.items():
            assert torch.equal(t, snap[k][n]), n
    for k, s in t2.state.opt_state.items():
        assert s.count == opt1[k][0]
        assert all(torch.equal(t, opt1[k][1][n]) for n, t in s.mu.items())
    out2 = t2.run()  # resumes again, into the restored tensors
    assert out2.step == 8 and t2.ckpt.latest_step() == 8


def test_denoiser_only_freezes_embedding(tiny_image_root, paths):
    pipe = make_pipe()
    ce_before = pipe.class_embedding.embedding.weight.detach().clone()
    trainer = SegmentedSDTrainer(pipe, make_config(tiny_image_root), paths,
                                 components_to_train=("denoiser",))
    state = trainer.run()
    assert torch.equal(state.params[TABLE], ce_before)
    assert not torch.equal(state.params["conv_in.weight"], pipe.unet.conv_in.weight)


def test_eval_best_model_save_and_reload(tiny_image_root, paths):
    pipe = make_pipe()
    # KID ranks the evals here: FID's host sqrtm of 2048 x 2048 takes ~13 s a class
    ev = EvalConfig(nb_generated_images=4, eval_batch_size=4, num_inference_steps=2,
                    main_metric="kernel_inception_distance_mean",
                    metrics=MetricsConfig(fid=False, isc=False, kid=True, kid_subset_size=2))
    trainer = SegmentedSDTrainer(
        pipe, make_config(tiny_image_root, eval_every_epochs=1, compute_metrics=True, eval=ev),
        paths)
    trainer.run()
    assert trainer.best_metric < float("inf")
    assert os.path.exists(os.path.join(paths.full_pipeline_save, "model_index.json"))
    reloaded = SDImg2ImgPipeline.from_pretrained(paths.full_pipeline_save, device="cpu")
    assert reloaded.unet_config == TINY_SD
    # the saved weights are the EMA tree
    assert torch.equal(reloaded.class_embedding.embedding.weight,
                       trainer.state.ema_params[TABLE])
    assert all(torch.equal(p, trainer.state.ema_params[n])
               for n, p in reloaded.unet.named_parameters())


def test_eval_generation_through_the_stages_equals_the_monolith(tiny_image_root, paths):
    """``make_generate_fn`` (the segmented stages on the EMA weights, with
    classifier-free guidance) equals the same sampler through ``SDUNet`` on
    those weights."""
    pipe = make_pipe()
    cfg = make_config(tiny_image_root)
    cfg.eval.guidance_factor = 2.0
    trainer = SegmentedSDTrainer(pipe, cfg, paths)
    labels = torch.tensor([0, 1, 1])
    got = trainer.make_generate_fn()(labels, torch.Generator().manual_seed(3), 2)
    ema = trainer.state.ema_params
    unet = SDUNet(TINY_SD)
    seq = pad_to_clip_sequence(ema[TABLE][labels])
    with torch.no_grad():
        lat = ddim_sample(
            lambda x, t, s: functional_call(unet, {n: ema[n] for n, _ in
                                                   unet.named_parameters()}, (x, t, s)),
            pipe.schedule, seq, shape=(3, 4, 4, 4), generator=torch.Generator().manual_seed(3),
            num_inference_steps=2, guidance=GuidanceConfig(2.0))
        want = decode_from_latents(pipe.vae, lat).float()
    assert got.shape == (3, 16, 16, 3)
    assert torch.equal(got, want)


def test_segmented_attention_fine_tuning_trains_only_attention(tiny_image_root, paths):
    trainer = SegmentedSDTrainer(make_pipe(), make_config(tiny_image_root), paths,
                                 components_to_train=("denoiser", "class_embedding"),
                                 attention_fine_tuning=True)
    before = {n: t.clone() for n, t in trainer.state.params.items()}
    state = trainer.run()
    n_attn = n_frozen = 0
    for n, b in before.items():
        module = n.split(".")[0]
        if module == "class_embedding" or _ATTENTION_MODULE_RE.match(module):
            n_attn += 1
            assert not torch.equal(state.params[n], b), f"should train: {n}"
        else:
            n_frozen += 1
            assert torch.equal(state.params[n], b), n
    assert n_attn > 1 and n_frozen > 0


def test_segmented_attention_fine_tuning_requires_denoiser(tiny_image_root, paths):
    with pytest.raises(ValueError, match="denoiser"):
        SegmentedSDTrainer(make_pipe(), make_config(tiny_image_root), paths,
                           components_to_train=("class_embedding",),
                           attention_fine_tuning=True)
    with pytest.raises(ValueError, match="segmented route"):
        SegmentedSDTrainer(make_pipe(), make_config(tiny_image_root), paths,
                           components_to_train=("denoiser", "autoencoder"))
