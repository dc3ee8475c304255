"""The port's comparison engine, its CLI and the Evaluator, on the CPU.

The engine runs on a 16 px two-class folder (4 PNGs a class) with a tiny
pipeline the JAX package saved, ``ddib`` and the guided method at 2 steps,
f32 weights (``inference_param_dtype=None``), beside the JAX engine on the
same inputs.  Both write the same output tree and file names and the same
``metrics.json`` keys; the ``ddib`` PNGs agree to one uint8 level (f32 in
another order, truncated to uint8).  Both engines get the same seeded
Inception weights (the port's init, carried into the JAX extractor by
``convert_torch_weights``) at ``PHENDIFF_INCEPTION_RESIZE=75``; FID is off
here because scipy's ``sqrtm`` of a 2048 x 2048 matrix takes ~13 s on this
CPU, and the FID math is held against the JAX package in
``test_torch_metrics.py``.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from phendiff_tpu.core import SchedulerConfig as JaxSchedulerConfig
from phendiff_tpu.experiments import comparison as jax_comparison
from phendiff_tpu.metrics.inception import InceptionExtractor as JaxInceptionExtractor
from phendiff_tpu.metrics.inception import InceptionV3 as JaxInceptionV3
from phendiff_tpu.metrics.inception import convert_torch_weights
from phendiff_tpu.models import UNet2DConfig as JaxUNetConfig
from phendiff_tpu.pipelines import ConditionalDDIMPipeline as JaxPipeline
from phendiff_tpu_torch.cli.img2img_cli import apply_overrides
from phendiff_tpu_torch.cli.img2img_cli import main as cli_main
from phendiff_tpu_torch.data.imagefolder import scan_imagefolder
from phendiff_tpu_torch.experiments import comparison
from phendiff_tpu_torch.metrics.fidelity import MetricsConfig
from phendiff_tpu_torch.metrics.inception import InceptionExtractor
from phendiff_tpu_torch.obs.trackers import JSONLTracker
from phendiff_tpu_torch.train.eval_loop import EvalConfig, Evaluator, is_it_best_model

torch.set_num_threads(1)

TINY = dict(
    sample_size=16, block_out_channels=(8, 16),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1, norm_num_groups=4, attention_head_dim=4, num_class_embeds=2,
)
SCHED = JaxSchedulerConfig(num_train_timesteps=1000, timestep_spacing="trailing",
                           clip_sample=False)
METHODS = ["ddib", "linear_interp_custom_guidance_inverted_start"]
METRICS = {"fid": False, "isc": True, "kid": True, "kid_subset_size": 2, "kid_subsets": 3}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cmp")
    pipe = JaxPipeline.init_random(JaxUNetConfig(**TINY), SCHED, seed=2)
    dataclasses.replace(pipe, lane_pack=False).save_pretrained(str(root / "pipe"))
    rng = np.random.default_rng(0)
    for cls in ("DMSO", "drug"):
        (root / "data" / cls).mkdir(parents=True)
        for i in range(4):
            Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
                root / "data" / cls / f"img_{i}.png")
    return root


def _conf(root, out):
    return {
        "output_dir": str(root / out),
        "pipelines": {"ddim": str(root / "pipe")},
        "dataset_train": str(root / "data"),
        "definition": [16, 16],
        "methods": METHODS,
        "method_params": {m: {"batch_size": 4, "guidance_loss_scale": 1e-2} for m in METHODS},
        "num_inference_steps": 2,
        "metrics": METRICS,
        "inference_param_dtype": None,
    }


def _tree(out):
    return sorted(os.path.relpath(os.path.join(d, f), out)
                  for d, _, files in os.walk(out) for f in files)


def test_engine_matches_jax_engine(inputs, monkeypatch):
    monkeypatch.setenv("PHENDIFF_INCEPTION_RESIZE", "75")
    cfg = comparison.ComparisonConfig.from_dict(_conf(inputs, "port"))
    assert cfg.methods == tuple(METHODS) and cfg.definition == (16, 16)
    exp = comparison.ComparisonExperiment(cfg, device="cpu")
    port_sd = {k: v.numpy() for k, v in exp.extractor.model.state_dict().items()}

    def jax_extractor():  # the port's seeded weights, random-init semantics
        ext = JaxInceptionExtractor.__new__(JaxInceptionExtractor)
        ext.model, ext.pretrained = JaxInceptionV3(), False
        ext.variables = convert_torch_weights(port_sd)
        ext._apply = jax.jit(lambda x: ext.model.apply(ext.variables, x))
        return ext

    monkeypatch.setattr(jax_comparison, "InceptionExtractor", jax_extractor)
    (inputs / "conf.yaml").write_text(yaml.safe_dump(_conf(inputs, "jax")))
    jexp = jax_comparison.ComparisonExperiment(
        jax_comparison.ComparisonConfig.from_yaml(str(inputs / "conf.yaml")),
        devices=jax.devices()[:1])
    want = jexp.run()
    got = exp.run()

    port, ref = inputs / "port", inputs / "jax"
    tree = _tree(port)
    assert tree == _tree(ref)
    assert len([f for f in tree if f.endswith(".png") and "_to_" in f]) == 2 * 8
    for f in tree:
        if f.startswith("ddib/") and f.endswith(".png"):
            a = np.asarray(Image.open(port / f), dtype=np.int16)
            b = np.asarray(Image.open(ref / f), dtype=np.int16)
            assert np.abs(a - b).max() <= 1, f
    assert sorted(got) == sorted(want)
    assert "ddib/ddim/train/DMSO/kernel_inception_distance_mean" in got
    assert all(np.isfinite(v) for v in got.values())
    with open(port / "metrics.json") as f:
        assert json.load(f) == got
    with open(port / "timings.json") as f, open(ref / "timings.json") as g:
        timings = json.load(f)
        assert timings.keys() == json.load(g).keys()
    assert all(t["images"] == 8 for t in timings.values())


def test_cli_overrides_and_debug(inputs, monkeypatch, tmp_path):
    monkeypatch.setenv("PHENDIFF_INCEPTION_RESIZE", "75")
    cfg = comparison.ComparisonConfig.from_dict(_conf(inputs, "x"))
    cfg2 = apply_overrides(cfg, ["num_inference_steps=3", "debug=true", "seed=4",
                                 "methods=ddib,inverted_regeneration", "sweep_metric=a/b"])
    assert (cfg2.num_inference_steps, cfg2.debug, cfg2.seed, cfg2.sweep_metric) == (3, True, 4, "a/b")
    assert cfg2.methods == ("ddib", "inverted_regeneration")
    with pytest.raises(ValueError, match="unknown override"):
        apply_overrides(cfg, ["nope=1"])
    conf = _conf(inputs, "unused")
    conf["methods"] = ["classifier_free_guidance_forward_start"]
    conf["method_params"] = {conf["methods"][0]: {"batch_size": 4}}
    del conf["inference_param_dtype"]  # the default: bf16 weights and compute
    conf["metrics"] = {"fid": False, "isc": True, "kid": False}
    (tmp_path / "conf.yaml").write_text(yaml.safe_dump(conf))
    out = tmp_path / "cli_out"
    assert cli_main(["--config", str(tmp_path / "conf.yaml"), f"output_dir={out}",
                     "--debug", "--device", "cpu"]) == 0
    assert (out / "frozen_config.yaml").exists() and (out / "resolved_config.json").exists()
    pngs = list((out / "classifier_free_guidance_forward_start").rglob("*_to_*.png"))
    assert len(pngs) == 4  # debug: one batch of 4
    with open(out / "metrics.json") as f:
        assert "classifier_free_guidance_forward_start/ddim/train/inception_score_mean" in json.load(f)
    with open(out / "metrics.jsonl") as f:
        assert json.loads(f.readline())["step"] == 0
    with open(out / "resolved_config.json") as f:
        assert json.load(f)["inference_param_dtype"] == "bfloat16"
    pipe = comparison.ComparisonExperiment(
        comparison.ComparisonConfig.from_yaml(str(tmp_path / "conf.yaml")), device="cpu"
    ).pipes["ddim"]
    assert pipe.dtype == torch.bfloat16 and pipe.model.conv_in.weight.dtype == torch.bfloat16


def test_sd_pipeline_folder_is_a_later_slice(inputs, tmp_path):
    """The slice has come: an ``SDImg2ImgPipeline`` folder loads as the
    port's SD pipeline (``tests/test_torch_sd_pipeline.py`` holds its route
    against the JAX engine), and a folder of neither kind still raises."""
    from phendiff_tpu_torch.core.scheduler import SchedulerConfig
    from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKLConfig
    from phendiff_tpu_torch.models.sd_unet import SDUNetConfig
    from phendiff_tpu_torch.pipelines import io
    from phendiff_tpu_torch.pipelines.sd_img2img import SDImg2ImgPipeline

    sd = SDImg2ImgPipeline.init_random(
        SDUNetConfig(sample_size=2, block_out_channels=(8, 8),
                     down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                     up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), layers_per_block=1,
                     cross_attention_dim=8, attention_head_dim=2, norm_num_groups=4),
        AutoencoderKLConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                            norm_num_groups=4), SchedulerConfig(), class_embedding_dim=8,
        device="cpu")
    sd.save_pretrained(str(tmp_path / "sd"))
    conf = dict(_conf(inputs, "sd"), pipelines={"sd": str(tmp_path / "sd")})
    exp = comparison.ComparisonExperiment(comparison.ComparisonConfig.from_dict(conf),
                                          device="cpu")
    assert isinstance(exp.pipes["sd"], SDImg2ImgPipeline)
    io.save_model_index(str(tmp_path / "other"), "OtherPipeline", {})
    conf = dict(_conf(inputs, "sd"), pipelines={"x": str(tmp_path / "other")})
    with pytest.raises(ValueError, match="unknown pipeline kind"):
        comparison.ComparisonExperiment(comparison.ComparisonConfig.from_dict(conf),
                                        device="cpu")


def test_cli_takes_the_override_flag_of_the_jax_launcher(inputs, monkeypatch, tmp_path):
    """``--override key=value ...``, as ``phendiff_tpu/cli/launcher.py``'s
    ``build_command`` emits it for the JAX app, configures the port's app."""
    from phendiff_tpu.cli.launcher import build_command

    monkeypatch.setenv("PHENDIFF_INCEPTION_RESIZE", "75")
    conf = _conf(inputs, "unused")
    conf["methods"] = ["inverted_regeneration"]
    conf["method_params"] = {"inverted_regeneration": {"batch_size": 4}}
    conf["metrics"] = {"fid": False, "isc": True, "kid": False}
    (tmp_path / "conf.yaml").write_text(yaml.safe_dump(conf))
    out = tmp_path / "flag_out"
    cmd = build_command(str(tmp_path / "conf.yaml"),
                        [f"output_dir={out}", "num_inference_steps=1", "seed=3"], debug=False)
    argv = cmd[cmd.index("--config"):]
    assert argv[2] == "--override"
    assert cli_main(argv + ["--device", "cpu"]) == 0
    with open(out / "resolved_config.json") as f:
        resolved = json.load(f)
    assert (resolved["num_inference_steps"], resolved["seed"]) == (1, 3)
    assert len(list((out / "inverted_regeneration").rglob("*_to_*.png"))) == 8


def _evaluator(index, definition, cache_root, extractor=None):
    cfg = EvalConfig(nb_generated_images=3, eval_batch_size=2, num_inference_steps=1,
                     main_metric="kernel_inception_distance_mean",
                     metrics=MetricsConfig(fid=False, isc=True, kid=True, kid_subset_size=2,
                                           kid_subsets=3))
    return Evaluator(cfg, index, definition, cache_root=cache_root,
                     extractor=extractor or InceptionExtractor(device="cpu"))


def test_evaluator_keys_panels_and_seeds(tiny_image_root, tmp_path, monkeypatch):
    monkeypatch.setenv("PHENDIFF_INCEPTION_RESIZE", "75")
    index = scan_imagefolder(tiny_image_root)
    ev = _evaluator(index, (16, 16), str(tmp_path / "cache"))
    seen = []

    def generate(labels, generator, num_inference_steps):
        # a RowsOf: this process's rows (all of them here) of the batch's draw
        seen.append((labels.tolist(), generator.generator.initial_seed(), num_inference_steps))
        full = torch.rand(generator.batch, 16, 16, 3, generator=generator.generator)
        return full[generator.rows] * 2 - 1

    tracker = JSONLTracker(str(tmp_path / "run"))
    m = ev.evaluate(generate, step=7, tracker=tracker)
    tracker.finish()
    for name in index.classes:
        for k in ("inception_score_mean", "inception_score_std",
                  "kernel_inception_distance_mean", "kernel_inception_distance_std"):
            assert np.isfinite(m[f"{name}/{k}"])
    assert m["main_metric_mean"] == pytest.approx(np.mean(
        [m[f"{c}/kernel_inception_distance_mean"] for c in index.classes]))
    assert m["inception_pretrained"] == 0.0
    # 2 batches of 2 per class (3 images, full batches), one fixed seed each
    assert [s[0] for s in seen] == [[0, 0]] * 2 + [[1, 1]] * 2
    assert len({s[1] for s in seen}) == 4
    seen_first = list(seen)
    seen.clear()
    assert ev.evaluate(generate, step=8) == m  # eval seed: the same samples again
    assert seen == seen_first
    panels = os.listdir(tmp_path / "run" / "images" / "step_00000007")
    assert sorted(panels)[:2] == ["samples_DMSO_000.png", "samples_DMSO_001.png"]
    assert is_it_best_model(1.0, float("inf")) and not is_it_best_model(2.0, 1.0)


def test_evaluator_cache_key_tracks_the_reference_set(tiny_image_root, tmp_path, monkeypatch):
    monkeypatch.setenv("PHENDIFF_INCEPTION_RESIZE", "75")
    index = scan_imagefolder(tiny_image_root)
    ext = InceptionExtractor(device="cpu")
    ev = _evaluator(index, (16, 16), str(tmp_path / "cache"), ext)
    key = ev._cache_key(0, "DMSO")
    assert key.startswith("DMSO_") and key == ev._cache_key(0, "DMSO")
    assert _evaluator(index, (32, 32), None, ext)._cache_key(0, "DMSO") != key
    fewer = index.subset([i for i in range(len(index)) if i != 0])
    assert _evaluator(fewer, (16, 16), None, ext)._cache_key(0, "DMSO") != key
    assert ev._cache_key(1, "drug") != key
    feats = ev._reference_features(0, "DMSO")
    assert feats.shape == (16, 2048)
    assert os.path.exists(tmp_path / "cache" / f"{key}.npz")
    assert np.array_equal(ev.cache.get(key)["features"], feats)
