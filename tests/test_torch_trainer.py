"""The port's Trainer, checkpoints, data loader and trackers, on the CPU.

A tiny conditional DDIM (one ``AttnDownBlock2D``) trains on the tiny
two-class image folder of ``conftest.py``.  The loader is held against the
JAX package's ``ImageFolderLoader`` batch for batch (both use the port's
build of the native resize library, so the comparison is of the loader's
logic).  Resume is exact: a run stopped and resumed from its latest
checkpoint ends with parameters bit-equal to an uninterrupted run (f32 on
the CPU is deterministic; flips are off, since the flip stream restarts at
the resumed batch in both packages).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from phendiff_tpu.data import imagefolder as jax_imagefolder
from phendiff_tpu.data import native as jax_native
from phendiff_tpu_torch.core.scheduler import SchedulerConfig
from phendiff_tpu_torch.data import native
from phendiff_tpu_torch.data.imagefolder import (
    ImageFolderLoader,
    LoaderConfig,
    balanced_subsample,
    scan_imagefolder,
)
from phendiff_tpu_torch.models.config import UNet2DConfig
from phendiff_tpu_torch.obs.trackers import JSONLTracker, NullTracker, make_tracker
from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
from phendiff_tpu_torch.train.checkpoints import CheckpointManager
from phendiff_tpu_torch.train.train_loop import (
    OptimizerConfig,
    TrainConfig,
    init_train_state,
    make_optimizer,
)
from phendiff_tpu_torch.train.trainer import (
    RunPaths,
    TrainerConfig,
    attention_param_mask,
    build_data,
    for_ddim_pipeline,
)

torch.set_num_threads(1)

TINY_UNET = UNet2DConfig(
    sample_size=16, block_out_channels=(8, 16),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1, norm_num_groups=4, attention_head_dim=4, num_class_embeds=2,
)
SCHED = SchedulerConfig(num_train_timesteps=20, clip_sample=False)


def make_config(data_dir, **overrides):
    base = dict(
        train_data_dir=str(data_dir), definition=(16, 16), train_batch_size=8,
        num_epochs=2, eval_every_epochs=None, checkpointing_steps=2, mixed_precision="no",
        compute_metrics=False,  # these tests check the loop, not the Evaluator
        train=TrainConfig(proba_uncond=0.1,
                          optimizer=OptimizerConfig(learning_rate=1e-3, total_steps=50)),
    )
    base.update(overrides)
    return TrainerConfig(**base)


def make_trainer(data_dir, tmp_path, run="run0", **overrides):
    pipe = ConditionalDDIMPipeline.init_random(TINY_UNET, SCHED, seed=0, device="cpu")
    paths = RunPaths.create(str(tmp_path), "exp", run)
    return for_ddim_pipeline(pipe, make_config(data_dir, **overrides), paths), paths


def _records(paths):
    with open(os.path.join(paths.run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_run_paths_layout(tmp_path):
    p = RunPaths.create(str(tmp_path), "exp", "run0")
    assert os.path.isdir(p.checkpoints) and os.path.isdir(p.fidelity_cache)
    assert p.full_pipeline_save == os.path.join(str(tmp_path), "exp", "run0",
                                                "full_pipeline_save")


def test_trainer_runs_logs_and_rotates_checkpoints(tiny_image_root, tmp_path):
    trainer, paths = make_trainer(tiny_image_root, tmp_path, checkpoints_total_limit=2,
                                  metrics_flush_every=3)
    state = trainer.run()
    assert state.step == 8  # 32 images / batch 8 = 4 steps x 2 epochs
    recs = _records(paths)
    assert [r["step"] for r in recs] == list(range(1, 9))
    assert [r["epoch"] for r in recs] == [0] * 4 + [1] * 4
    for r in recs:
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) and r["nonfinite"] == 0
        assert r["lr"] == pytest.approx(1e-3) and "perf/t_data_s" in r
    assert trainer.ckpt.all_steps() == [6, 8]
    assert all(torch.isfinite(p).all() for p in state.params.values())


def test_resume_from_latest_is_exact(tiny_image_root, tmp_path):
    kw = dict(data_aug_on_the_fly=False, checkpointing_steps=1)
    full, _ = make_trainer(tiny_image_root, tmp_path, "full", **kw)
    want = full.run()
    part, paths = make_trainer(tiny_image_root, tmp_path, "part", max_train_steps=5,
                               save_final_checkpoint=False, **kw)
    assert part.run().step == 5
    resumed, _ = make_trainer(tiny_image_root, tmp_path, "part", resume_from_checkpoint="latest",
                              **kw)
    assert resumed.maybe_resume() == (1, 1)  # epoch 1, one batch already consumed
    got = resumed.run()
    assert got.step == 8
    for n, p in want.params.items():
        assert torch.equal(got.params[n], p), n
        assert torch.equal(got.ema_params[n], want.ema_params[n]), n
    assert [r["step"] for r in _records(paths)] == [1, 2, 3, 4, 5, 6, 7, 8]


def test_eval_saves_ema_pipeline_once_and_it_loads(tiny_image_root, tmp_path):
    trainer, paths = make_trainer(tiny_image_root, tmp_path, eval_every_epochs=1)
    trainer.run()
    # the first eval (end of epoch 0, step 4) saved; the second found it populated
    loaded = ConditionalDDIMPipeline.from_pretrained(paths.full_pipeline_save, device="cpu")
    ema4 = trainer.ckpt.restore(init_train_state(trainer.state.params, trainer.optimizer),
                                step=4).ema_params
    for n, p in loaded.model.named_parameters():
        assert torch.equal(p, ema4[n]), n
    assert loaded.scheduler_config == SCHED
    out = loaded.generate(torch.tensor([0, 1]), torch.Generator().manual_seed(0),
                          num_inference_steps=2)
    assert out.shape == (2, 16, 16, 3) and torch.isfinite(out).all()


def test_upload_uint8_and_attention_fine_tuning(tiny_image_root, tmp_path):
    pipe = ConditionalDDIMPipeline.init_random(TINY_UNET, SCHED, seed=0, device="cpu")
    paths = RunPaths.create(str(tmp_path), "exp", "ft")
    cfg = make_config(tiny_image_root, upload_uint8=True, max_train_steps=2)
    trainer = for_ddim_pipeline(pipe, cfg, paths, attention_fine_tuning=True)
    before = {n: p.detach().clone() for n, p in trainer.state.params.items()}
    state = trainer.run()
    mask = attention_param_mask(state.params)
    for n, p in state.params.items():
        assert torch.equal(p, before[n]) != mask[n], n
    assert all(np.isfinite(r["loss"]) for r in _records(paths))


def test_attention_param_mask_matches_jax():
    import jax
    import jax.numpy as jnp

    from phendiff_tpu.models import CondUNet2D as JaxUNet
    from phendiff_tpu.models import UNet2DConfig as JaxConfig
    from phendiff_tpu.train.trainer import attention_param_mask as jax_mask

    kw = {f.name: getattr(TINY_UNET, f.name) for f in dataclasses.fields(TINY_UNET)}
    shapes = jax.eval_shape(lambda: JaxUNet(JaxConfig(**kw), lane_pack=False).init(
        jax.random.key(0), jnp.zeros((1, 16, 16, 3)), jnp.array([0]),
        class_labels=jnp.array([0])))
    leaves, _ = jax.tree_util.tree_flatten_with_path(jax_mask(shapes))
    want = {}
    for path, m in leaves:  # Flax key -> the port's name (the converter's renaming)
        *scope, leaf = [k.key for k in path][1:]
        leaf = {"kernel": "weight", "embedding": "weight"}.get(leaf, leaf)
        want[".".join([*scope, leaf])] = bool(m)
    pipe = ConditionalDDIMPipeline.init_random(TINY_UNET, SCHED, seed=0, device="cpu")
    assert attention_param_mask(dict(pipe.model.named_parameters())) == want
    assert 0 < sum(want.values()) < len(want)


def test_compute_metrics_is_a_later_slice(tiny_image_root, tmp_path, monkeypatch):
    """The slice has come: ``compute_metrics=True`` runs the Evaluator at
    the end of an epoch and saves the EMA pipeline as the best model."""
    from phendiff_tpu_torch.metrics.fidelity import MetricsConfig
    from phendiff_tpu_torch.train.eval_loop import EvalConfig

    monkeypatch.setenv("PHENDIFF_INCEPTION_RESIZE", "75")
    ev = EvalConfig(nb_generated_images=2, eval_batch_size=2, num_inference_steps=2,
                    main_metric="kernel_inception_distance_mean",
                    metrics=MetricsConfig(fid=False, isc=True, kid=True, kid_subset_size=2,
                                          kid_subsets=3))
    trainer, paths = make_trainer(tiny_image_root, tmp_path, compute_metrics=True, eval=ev,
                                  num_epochs=1, eval_every_epochs=1, max_train_steps=1)
    assert trainer.evaluator is not None and trainer.evaluator.device.type == "cpu"
    trainer.run()
    rec = [r for r in _records(paths) if "main_metric_mean" in r]
    assert len(rec) == 1 and rec[0]["step"] == 1 and rec[0]["inception_pretrained"] == 0.0
    assert np.isfinite(rec[0]["DMSO/kernel_inception_distance_mean"])
    assert trainer.best_metric == rec[0]["main_metric_mean"]
    loaded = ConditionalDDIMPipeline.from_pretrained(paths.full_pipeline_save, device="cpu")
    assert all(torch.equal(p, trainer.state.ema_params[n])
               for n, p in loaded.model.named_parameters())
    assert os.listdir(os.path.join(paths.run_dir, "images", "step_00000001"))


def test_checkpoint_rotation_and_restore(tmp_path):
    params = {"w": torch.randn(3, 4), "b": torch.randn(4)}
    opt = make_optimizer(OptimizerConfig())
    mgr = CheckpointManager(str(tmp_path / "ckpt"), total_limit=3)
    with pytest.raises(FileNotFoundError):
        mgr.restore(init_train_state(params, opt))
    saved = {}
    for step in range(1, 6):
        state = init_train_state({n: p + step for n, p in params.items()}, opt)
        state.step = step
        state.opt_state.count = step
        state.opt_state.mu["w"].fill_(0.5 * step)
        mgr.save(step, state)
        saved[step] = state
    assert mgr.all_steps() == [3, 4, 5] and mgr.latest_step() == 5
    assert sorted(os.listdir(mgr.directory)) == ["3", "4", "5"]  # no temporary left
    for step in (None, 4):
        got = mgr.restore(init_train_state(params, opt), step=step)
        want = saved[step or 5]
        assert got.step == want.step and got.opt_state.count == want.opt_state.count
        for a, b in ((got.params, want.params), (got.ema_params, want.ema_params),
                     (got.opt_state.mu, want.opt_state.mu), (got.opt_state.nu, want.opt_state.nu)):
            assert all(torch.equal(a[n], b[n]) for n in b)


def test_loader_matches_jax_loader(tiny_image_root, monkeypatch):
    # both packages resize through the same native library (the port's build)
    monkeypatch.setattr(jax_native, "get_lib", native.get_lib)
    index = scan_imagefolder(tiny_image_root)
    jindex = jax_imagefolder.scan_imagefolder(tiny_image_root)
    assert index.paths == jindex.paths and index.labels == jindex.labels
    sub = balanced_subsample(index, 50, seed=3)
    assert sub.paths == jax_imagefolder.balanced_subsample(jindex, 50, seed=3).paths
    trained, _, full = build_data(make_config(tiny_image_root, perc_samples=50, seed=3))
    assert trained.paths == sub.paths and full.paths == index.paths
    for transport in ("f32", "uint8"):
        cfg = dict(batch_size=5, definition=(12, 10), random_flip=True, seed=4,
                   transport=transport)
        loader = ImageFolderLoader(index, LoaderConfig(**cfg))
        jloader = jax_imagefolder.ImageFolderLoader(jindex, jax_imagefolder.LoaderConfig(**cfg))
        assert len(loader) == len(jloader) == 6
        got = list(loader.epoch(1, skip_batches=2))
        want = list(jloader.epoch(1, skip_batches=2))
        assert len(got) == len(want) == 4
        for (gi, gl), (wi, wl) in zip(got, want):
            assert gi.dtype == wi.dtype and gi.shape == (5, 12, 10, 3)
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("normalize,flip_h,flip_v,antialias", [
    (True, False, False, True), (True, True, False, True), (True, True, True, False),
    (False, False, True, True),
])
def test_resize_normalize_matches_the_batch_form_and_jax(monkeypatch, normalize, flip_h,
                                                         flip_v, antialias):
    monkeypatch.setattr(jax_native, "get_lib", native.get_lib)
    img = np.random.default_rng(1).integers(0, 256, (23, 17, 3), dtype=np.uint8)
    kw = dict(normalize=normalize, antialias=antialias)
    got = native.resize_normalize(img, (9, 12), flip_h=flip_h, flip_v=flip_v, **kw)
    assert got.shape == (9, 12, 3) and got.dtype == np.float32
    batch = native.batch_resize_normalize([img], (9, 12), flips=np.array([[flip_h, flip_v]]),
                                          **kw)
    np.testing.assert_array_equal(got, batch[0])
    np.testing.assert_array_equal(
        got, jax_native.resize_normalize(img, (9, 12), flip_h=flip_h, flip_v=flip_v, **kw))


def test_native_library_builds_under_a_content_hash():
    if not native.available():
        pytest.skip("no C++ compiler: the loader uses its numpy + PIL fallback")
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD
    assert path.name.startswith("libphendiff_native-") and path.suffix == ".so"
    img = np.random.default_rng(0).integers(0, 255, (9, 7, 3), dtype=np.uint8)
    out = native.batch_resize_normalize([img, img[:5]], (4, 5))
    assert out.shape == (2, 4, 5, 3) and -1.0 <= out.min() and out.max() <= 1.0


def test_trackers(tmp_path):
    run_dir = str(tmp_path / "run")
    t = make_tracker("jsonl", run_dir)
    assert isinstance(t, JSONLTracker)
    t.log({"loss": 0.5, "note": "x"}, 3)
    t.alert("NaN", "first")
    t.alert("NaN", "second, within the cooldown")
    t.finish()
    again = JSONLTracker(run_dir)
    assert again.run_id == t.run_id  # the run id persists for resume
    again.finish()
    (rec,) = _records(RunPaths(run_dir, "", "", ""))
    assert rec["step"] == 3 and rec["loss"] == 0.5 and rec["note"] == "x"
    with open(os.path.join(run_dir, "alerts.log")) as f:
        assert f.read().count("[NaN]") == 1
    assert isinstance(make_tracker("none", run_dir), NullTracker)
    with pytest.raises(ValueError):
        make_tracker("tensorboard", run_dir)


def test_compute_metrics_default_matches_the_jax_package():
    """A default run keeps the best pipeline by FID, as the reference does."""
    from phendiff_tpu.train.trainer import TrainerConfig as JaxTrainerConfig

    assert TrainerConfig().compute_metrics is JaxTrainerConfig().compute_metrics is True

