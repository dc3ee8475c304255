"""The port's training entry point and host tools against the JAX package's,
on the CPU.

* ``cli/args.py``: the port's parser takes every flag of the JAX parser
  with the same destination, choices, default and arity (plus its own
  ``--device``), and the flags of ``examples/launch_train_ddim.sh`` parse to
  the same values; ``check_args`` and ``modify_args_for_debug`` agree with
  the JAX functions over a table of argument sets; the flags the port does
  not run raise ``NotImplementedError``, and so do the JAX CLI's refusals on
  the segmented route.
* ``cli/train_cli.py``: ``trainer_config_from_args`` gives the JAX
  function's values; ``main`` runs a DDIM and an SD ``--debug`` training on
  the CPU, and the SD one on the segmented route in each clip mode, with the
  run-dir layout of ``tests/test_cli.py`` and a reloadable save.
* ``cli/factory.py``, ``obs/logging_utils.py``, ``cli/prepare_data.py`` and
  ``cli/launcher.py``: the scheduler-override precedence, the factory's
  dispatch, the logger's format, and the same files and commands as the
  JAX package's tools on the same inputs.
"""

import dataclasses
import json
import logging
import os
import shlex

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from phendiff_tpu.cli import args as jax_args
from phendiff_tpu.cli import factory as jax_factory
from phendiff_tpu.cli import launcher as jax_launcher
from phendiff_tpu.cli import prepare_data as jax_prepare
from phendiff_tpu.cli import train_cli as jax_train_cli
from phendiff_tpu.core import SchedulerConfig as JaxSchedulerConfig
from phendiff_tpu_torch.cli import args as A
from phendiff_tpu_torch.cli import factory, launcher, prepare_data, train_cli
from phendiff_tpu_torch.core.scheduler import SchedulerConfig
from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKLConfig
from phendiff_tpu_torch.models.config import UNet2DConfig
from phendiff_tpu_torch.models.sd_unet import SDUNetConfig
from phendiff_tpu_torch.obs.logging_utils import setup_logger
from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
from phendiff_tpu_torch.pipelines.sd_img2img import SDImg2ImgPipeline

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--run_name", "t", "--model_type", "DDIM", "--train_data_dir", "/tmp/x",
        "--denoiser_config_path", "/tmp/d.json", "--eval_save_model_every_epochs", "1"]
SD = ["--run_name", "t", "--model_type", "StableDiffusion", "--train_data_dir", "/tmp/x",
      "--pretrained_model_name_or_path", "/tmp/p", "--eval_save_model_every_epochs", "1"]
TINY_UNET = UNet2DConfig(
    sample_size=16, block_out_channels=(8, 8),
    down_block_types=("DownBlock2D", "DownBlock2D"), up_block_types=("UpBlock2D", "UpBlock2D"),
    layers_per_block=1, norm_num_groups=4, num_class_embeds=2,
)
TINY_SD = SDUNetConfig(
    sample_size=4, block_out_channels=(16, 32),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, cross_attention_dim=16, attention_head_dim=(2, 4), norm_num_groups=4,
)
TINY_VAE = AutoencoderKLConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                               norm_num_groups=4, latent_channels=4, sample_size=32)
SCHED = SchedulerConfig(num_train_timesteps=20, clip_sample=False)


def _options(parser):
    return {opt: a for a in parser._actions for opt in a.option_strings}


def _parse_both(argv):
    return jax_args.build_parser().parse_args(argv), A.build_parser().parse_args(argv)


def _launch_script_flags():
    """The flags of ``examples/launch_train_ddim.sh``, with its defaults."""
    with open(os.path.join(ROOT, "examples", "launch_train_ddim.sh")) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if "train_cli" in ln)
    words = shlex.split(line.replace('"${DATA_DIR:-data/prepared/train}"', "data"))
    return [w for w in words[words.index("phendiff_tpu.cli.train_cli") + 1:] if w != "$@"]


def test_parser_takes_every_flag_of_the_jax_parser():
    jax_opts, port_opts = _options(jax_args.build_parser()), _options(A.build_parser())
    assert set(port_opts) - set(jax_opts) == {"--device"}
    assert set(jax_opts) <= set(port_opts)
    for opt, a in jax_opts.items():
        b = port_opts[opt]
        # the port's model types are the JAX parser's and DiT, which the JAX
        # package lacks
        choices = tuple(a.choices) + ("DiT",) if opt == "--model_type" else a.choices
        assert (b.dest, b.choices, b.default, b.nargs, b.required, b.const, type(b)) == (
            a.dest, choices, a.default, a.nargs, a.required, a.const, type(a)), opt
        assert getattr(b.type, "__name__", b.type) == getattr(a.type, "__name__", a.type), opt
    flags = _launch_script_flags()
    assert "--proba_uncond" in flags and "--definition" in flags
    want, got = _parse_both(flags)
    assert {k: v for k, v in vars(got).items() if k != "device"} == vars(want)
    assert A.parse_definition("64,96") == jax_args.parse_definition("64,96") == (64, 96)
    assert A.MAIN_METRIC_NAMES == jax_args.MAIN_METRIC_NAMES


# (extra flags, attributes set after parsing, base command line)
CHECK_CASES = [
    ([], {}, BASE),
    (["--gradient_accumulation_steps", "2"], {}, BASE),
    (["--components_to_train", "autoencoder"], {}, BASE),
    (["--components_to_train", "class_embedding"], {}, BASE),
    (["--components_to_train", "class_embedding", "--attention_fine_tuning"], {}, SD),
    (["--components_to_train", "denoiser", "autoencoder", "--attention_fine_tuning"], {}, SD),
    (["--pretrained_model_name_or_path", "/some/pipe"], {}, BASE),
    (["--pretrained_model_name_or_path", "/p", "--learn_denoiser_from_scratch"], {}, BASE),
    ([], {"pretrained_model_name_or_path": None}, SD),
    ([], {"denoiser_config_path": None}, BASE),
    ([], {"train_data_dir": None}, BASE),
    ([], {"train_data_dir": None, "dataset_name": "/some/hf"}, BASE),
    ([], {"eval_save_model_every_epochs": None}, BASE),
    (["--eval_save_model_every_opti_steps", "5"], {"eval_save_model_every_epochs": None}, BASE),
    ([], {"num_epochs": None}, BASE),
    (["--proba_uncond", "1.0"], {}, BASE),
    (["--proba_uncond", "1.0", "--guidance_factor", "5.0"], {}, BASE),
    (["--proba_uncond", "1.0"], {}, SD),
    (["--proba_uncond", "0.1", "--guidance_factor", "2.5"], {}, BASE),
    (["--proba_uncond", "1.5"], {}, BASE),
    (["--compute_kid", "--nb_generated_images", "100", "--kid_subset_size", "1000"], {}, BASE),
    (["--compute_kid", "--nb_generated_images", "100", "--kid_subset_size", "1000", "--debug"],
     {}, BASE),
    (["--perc_samples", "0"], {}, BASE),
    (["--perc_samples", "50"], {}, BASE),
    (["--main_metric", "isc"], {}, BASE),
    (["--main_metric", "kid", "--compute_kid"], {}, BASE),
    (["--model_parallel", "0"], {}, BASE),
    (["--mixed_precision", "fp16"], {}, BASE),
    (["--logger", "wandb"], {}, BASE),
    (["--dataloader_num_workers", "8", "--pin_memory", "--local_rank", "0", "--push_to_hub",
      "--hub_model_id", "x/y", "--revision", "fp16", "--persistent_workers"], {}, BASE),
    (["--debug", "--nb_generated_images", "40"], {}, BASE),
    (["--debug", "--max_num_steps", "5", "--train_batch_size", "32"], {}, SD),
]


def test_training_refuses_dit():
    args = A.build_parser().parse_args(
        ["--run_name", "t", "--model_type", "DiT", "--train_data_dir", "/tmp/x",
         "--pretrained_model_name_or_path", "/tmp/p", "--eval_save_model_every_epochs", "1"])
    with pytest.raises(ValueError, match="training a DiT is not supported"):
        A.check_args(args)
    with pytest.raises(ValueError, match="training a DiT is not supported"):
        train_cli.main(["--run_name", "t", "--model_type", "DiT", "--train_data_dir", "/tmp/x",
                        "--pretrained_model_name_or_path", "/tmp/p",
                        "--eval_save_model_every_epochs", "1", "--device", "cpu"])


@pytest.mark.parametrize("extra,attrs,base", CHECK_CASES)
def test_check_args_and_debug_agree_with_jax(extra, attrs, base):
    jargs, targs = _parse_both(base + extra)
    outcomes = []
    for mod, args in ((jax_args, jargs), (A, targs)):
        for k, v in attrs.items():
            setattr(args, k, v)
        if args.debug:
            mod.modify_args_for_debug(args)
        try:
            warnings = mod.check_args(args)
            # the JAX package says where fp16 goes; the mapping is the same
            outcomes.append(("ok", [w.replace(" on TPU", "") for w in warnings]))
        except (ValueError, NotImplementedError) as e:
            outcomes.append((type(e), str(e)))
    assert outcomes[1] == outcomes[0]
    assert {k: v for k, v in vars(targs).items() if k != "device"} == vars(jargs)


def _common(a, b):
    """The fields two config dataclasses share, recursively, as dicts."""
    if dataclasses.is_dataclass(a):
        names = {f.name for f in dataclasses.fields(a)} & {f.name for f in dataclasses.fields(b)}
        return ({n: _common(getattr(a, n), getattr(b, n))[0] for n in sorted(names)},
                {n: _common(getattr(a, n), getattr(b, n))[1] for n in sorted(names)})
    return a, b


@pytest.mark.parametrize("extra", [
    [], ["--debug"], ["--remat", "--precise_first_n_epochs", "2", "--perc_samples", "50",
                      "--no_compute_metrics_full_dataset", "--dataloader_prefetch_factor", "4",
                      "--compute_isc", "--main_metric", "isc", "--proba_uncond", "1.0"],
])
def test_trainer_config_from_args_matches_jax(extra):
    jargs, targs = _parse_both(_launch_script_flags() + extra)
    for mod, args in ((jax_args, jargs), (A, targs)):
        if args.debug:
            mod.modify_args_for_debug(args)
    got, want = _common(train_cli.trainer_config_from_args(targs),
                        jax_train_cli.trainer_config_from_args(jargs))
    assert got == want
    assert set(want) >= {"remat", "eval_every_opti_steps", "precise_first_n_epochs",
                         "compute_metrics_full_dataset", "loader_prefetch", "train", "eval"}


@pytest.mark.parametrize("extra,match", [
    # the JAX CLI's refusal of tensor parallelism on the segmented route
    (["--model_type", "StableDiffusion", "--pretrained_model_name_or_path", "/tmp/p",
      "--learn_denoiser_from_scratch", "--model_parallel", "2", "--segmented_sd", "on"],
     "parallelism"),
])
def test_flags_the_port_does_not_run_raise(extra, match):
    args = A.build_parser().parse_args(BASE + extra)
    A.check_args(args)
    with pytest.raises(NotImplementedError, match=match):
        train_cli.trainer_config_from_args(args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_moment_dtype_reaches_the_optimizer_config_as_in_jax(dtype):
    jargs, targs = _parse_both(BASE + ["--adam_moment_dtype", dtype])
    got = train_cli.trainer_config_from_args(targs).train.optimizer.moment_dtype
    want = jax_train_cli.trainer_config_from_args(jargs).train.optimizer.moment_dtype
    assert got == want == dtype


@pytest.mark.parametrize("extra,field,value", [
    (["--dataset_name", "/some/hf", "--split", "test", "--cache_dir", "/c"],
     ("dataset_name", "split", "cache_dir"), ("/some/hf", "test", "/c")),
    (["--tracker", "wandb"], ("tracker",), ("wandb",)),
])
def test_hf_dataset_and_wandb_flags_reach_the_trainer_config_as_in_jax(extra, field, value):
    jargs, targs = _parse_both(BASE + extra)
    got = train_cli.trainer_config_from_args(targs)
    want = jax_train_cli.trainer_config_from_args(jargs)
    for f, v in zip(field, value):
        assert getattr(got, f) == getattr(want, f) == v


def test_segmented_sd_on_raises_and_auto_or_off_take_the_one_program_step(tmp_path,
                                                                           monkeypatch):
    """The JAX CLI's refusals on the segmented route stay (the VAE, a model
    axis), and so does its single process (a world > 1 names
    ``--segmented_sd off``); ``auto`` and ``off`` take the one-program step
    (they reach the loader: the folder does not exist)."""
    on = SD + ["--segmented_sd", "on", "--device", "cpu",
               "--exp_output_dirs_parent_folder", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="autoencoder"):
        train_cli.main(on + ["--components_to_train", "denoiser", "autoencoder"])
    with pytest.raises(NotImplementedError, match="parallelism"):
        train_cli.main(on + ["--model_parallel", "2"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="--segmented_sd off"):
        train_cli.main(on)
    monkeypatch.delenv("WORLD_SIZE")
    for mode in ("auto", "off"):
        with pytest.raises(FileNotFoundError):
            train_cli.main(SD + ["--segmented_sd", mode, "--device", "cpu",
                                 "--exp_output_dirs_parent_folder", str(tmp_path)])


def test_scheduler_override_precedence(tmp_path):
    jpath = tmp_path / "s.json"
    jpath.write_text(json.dumps({"num_train_timesteps": 500, "prediction_type": "v_prediction"}))

    class FakeArgs:
        prediction_type = "sample"
        num_train_timesteps = None
        beta_start = None
        beta_end = 0.03
        beta_schedule = None

    for path in (None, str(jpath)):
        out = factory.override_scheduler_config(SchedulerConfig(num_train_timesteps=1000),
                                                FakeArgs(), path)
        want = jax_factory.override_scheduler_config(
            JaxSchedulerConfig(num_train_timesteps=1000), FakeArgs(), path)
        assert out.to_json_dict() == want.to_json_dict()
        assert out.prediction_type == "sample" and out.beta_end == 0.03  # command line wins
        assert out.num_train_timesteps == (500 if path else 1000)  # then the file


def test_factory_ddim_and_sd(tmp_path):
    dpath = tmp_path / "d.json"
    dpath.write_text(json.dumps(TINY_UNET.to_json_dict()))
    args = A.build_parser().parse_args(BASE + ["--definition", "32", "--num_train_timesteps",
                                               "30", "--seed", "4"])
    args.denoiser_config_path = str(dpath)
    pipe = factory.load_initial_pipeline(args, device="cpu")
    assert isinstance(pipe, ConditionalDDIMPipeline) and pipe.device.type == "cpu"
    assert pipe.unet_config.sample_size == 32 and pipe.scheduler_config.num_train_timesteps == 30
    fresh = ConditionalDDIMPipeline.init_random(TINY_UNET.replace(sample_size=32), SCHED, seed=4,
                                                device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(pipe.model.parameters(),
                                                  fresh.model.parameters()))

    pipe.save_pretrained(str(tmp_path / "ddim"))
    args = A.build_parser().parse_args(BASE + ["--definition", "16", "--pretrained_model_name_or_path",
                                               str(tmp_path / "ddim")])
    args.denoiser_config_path = None
    loaded = factory.load_initial_pipeline(args, device="cpu")
    assert loaded.unet_config.sample_size == 16
    assert loaded.scheduler_config.num_train_timesteps == 30  # the pretrained scheduler
    assert all(torch.equal(p, q) for p, q in zip(loaded.model.parameters(),
                                                  pipe.model.parameters()))
    args.learn_denoiser_from_scratch, args.seed = True, 9
    scratch = factory.load_initial_pipeline(args, device="cpu")
    assert not torch.equal(scratch.model.conv_in.weight, pipe.model.conv_in.weight)
    assert scratch.scheduler_config.num_train_timesteps == 30

    sd = SDImg2ImgPipeline.init_random(TINY_SD, TINY_VAE, SCHED, num_classes=2,
                                       class_embedding_dim=16, seed=0, device="cpu")
    sd.save_pretrained(str(tmp_path / "sd"))
    args = A.build_parser().parse_args(SD + ["--definition", "64", "--pretrained_model_name_or_path",
                                             str(tmp_path / "sd"), "--prediction_type",
                                             "v_prediction"])
    loaded = factory.load_initial_pipeline(args, dtype=torch.bfloat16, device="cpu")
    assert isinstance(loaded, SDImg2ImgPipeline) and loaded.unet_config.sample_size == 8
    assert loaded.scheduler_config.prediction_type == "v_prediction"
    assert loaded.dtype == torch.bfloat16 and loaded.vae.dtype == torch.bfloat16
    assert torch.equal(loaded.unet.conv_in.weight, sd.unet.conv_in.weight)
    args.learn_denoiser_from_scratch = True
    scratch = factory.load_initial_pipeline(args, device="cpu")
    assert not torch.equal(scratch.unet.conv_in.weight, sd.unet.conv_in.weight)
    assert torch.equal(scratch.vae.encoder.conv_in.weight, sd.vae.encoder.conv_in.weight)
    assert torch.equal(scratch.class_embedding.embedding.weight,
                       sd.class_embedding.embedding.weight)


def _run_dir_layout(run_dir):
    assert (run_dir / "metrics.jsonl").exists() and (run_dir / "checkpoints").is_dir()
    recs = [json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert losses and all(np.isfinite(losses))
    assert os.listdir(run_dir / "checkpoints")
    return recs


def test_train_cli_ddim_end_to_end(tiny_image_root, tmp_path, capsys):
    dpath = tmp_path / "denoiser.json"
    dpath.write_text(json.dumps(TINY_UNET.to_json_dict()))
    rc = train_cli.main([
        "--run_name", "smoke", "--model_type", "DDIM", "--train_data_dir", str(tiny_image_root),
        "--denoiser_config_path", str(dpath), "--definition", "16", "--train_batch_size", "8",
        "--eval_batch_size", "4", "--nb_generated_images", "4", "--no_compute_fid",
        "--exp_output_dirs_parent_folder", str(tmp_path / "exp"), "--mixed_precision", "no",
        "--debug", "--device", "cpu",
    ])
    assert rc == 0
    run_dir = tmp_path / "exp" / "phendiff-tpu" / "smoke"
    recs = _run_dir_layout(run_dir)
    assert max(r["step"] for r in recs) == 12  # --debug: 3 epochs of 4 batches
    loaded = ConditionalDDIMPipeline.from_pretrained(str(run_dir / "full_pipeline_save"),
                                                     device="cpu")
    assert loaded.unet_config.sample_size == 16
    out = capsys.readouterr().out
    assert "devices=1 (cpu)" in out and "done: 12 steps" in out


def test_train_cli_sd_end_to_end(tiny_image_root, tmp_path):
    sd = SDImg2ImgPipeline.init_random(TINY_SD, TINY_VAE, SCHED, num_classes=2,
                                       class_embedding_dim=16, seed=0, device="cpu")
    sd.save_pretrained(str(tmp_path / "sd"))
    rc = train_cli.main([
        "--run_name", "sd", "--model_type", "StableDiffusion", "--train_data_dir",
        str(tiny_image_root), "--pretrained_model_name_or_path", str(tmp_path / "sd"),
        "--components_to_train", "denoiser", "class_embedding", "--definition", "16",
        "--train_batch_size", "8", "--eval_batch_size", "4", "--nb_generated_images", "4",
        "--no_compute_fid", "--exp_output_dirs_parent_folder", str(tmp_path / "exp"),
        "--mixed_precision", "no", "--remat", "--debug", "--device", "cpu",
    ])
    assert rc == 0
    run_dir = tmp_path / "exp" / "phendiff-tpu" / "sd"
    recs = _run_dir_layout(run_dir)
    assert [r["step"] for r in recs if "loss" in r] == list(range(1, 13))
    loaded = SDImg2ImgPipeline.from_pretrained(str(run_dir / "full_pipeline_save"), device="cpu")
    assert loaded.unet_config.sample_size == 2  # 16 px through the VAE's 8x downsampling
    assert not torch.equal(loaded.unet.conv_in.weight, sd.unet.conv_in.weight)
    assert torch.equal(loaded.vae.encoder.conv_in.weight, sd.vae.encoder.conv_in.weight)


@pytest.mark.parametrize("clip_mode", ["recompute", "cache", "cache_bf16"])
def test_train_cli_sd_segmented_end_to_end(tiny_image_root, tmp_path, capsys, clip_mode):
    """``--segmented_sd on`` trains through ``SegmentedSDTrainer`` in each
    ``--segmented_clip_mode``: the ``--debug`` run's layout, 12 steps, a
    reloadable EMA save with the UNet trained and the VAE as it was."""
    sd = SDImg2ImgPipeline.init_random(TINY_SD, TINY_VAE, SCHED, num_classes=2,
                                       class_embedding_dim=16, seed=0, device="cpu")
    sd.save_pretrained(str(tmp_path / "sd"))
    rc = train_cli.main([
        "--run_name", "seg", "--model_type", "StableDiffusion", "--train_data_dir",
        str(tiny_image_root), "--pretrained_model_name_or_path", str(tmp_path / "sd"),
        "--components_to_train", "denoiser", "class_embedding", "--definition", "16",
        "--train_batch_size", "8", "--eval_batch_size", "4", "--nb_generated_images", "4",
        "--no_compute_fid", "--exp_output_dirs_parent_folder", str(tmp_path / "exp"),
        "--mixed_precision", "no", "--debug", "--device", "cpu",
        "--segmented_sd", "on", "--segmented_clip_mode", clip_mode,
    ])
    assert rc == 0
    run_dir = tmp_path / "exp" / "phendiff-tpu" / "seg"
    recs = _run_dir_layout(run_dir)
    assert [r["step"] for r in recs if "loss" in r] == list(range(1, 13))
    assert all("grad_norm" in r for r in recs if "loss" in r)
    loaded = SDImg2ImgPipeline.from_pretrained(str(run_dir / "full_pipeline_save"), device="cpu")
    assert not torch.equal(loaded.unet.conv_in.weight, sd.unet.conv_in.weight)
    assert torch.equal(loaded.vae.encoder.conv_in.weight, sd.vae.encoder.conv_in.weight)
    assert "done: 12 steps" in capsys.readouterr().out


def test_setup_logger_format(capsys):
    logger = setup_logger("phendiff_test_logger", main_process_only=True)
    assert logger.level == logging.INFO and len(logger.handlers) == 1
    assert setup_logger("phendiff_test_logger").handlers == logger.handlers  # no second handler
    logger.info("hello")
    err = capsys.readouterr().err
    assert "[p0] INFO phendiff_test_logger: hello" in err


@pytest.mark.parametrize("augment", [False, True])
def test_prepare_data_matches_jax(tiny_image_root, tmp_path, augment):
    stats = prepare_data.prepare(str(tiny_image_root), str(tmp_path / "port"), 0.25, augment, 3)
    want = jax_prepare.prepare(str(tiny_image_root), str(tmp_path / "jax"), 0.25, augment, 3)
    assert stats == want

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    port_files = files(tmp_path / "port")
    assert port_files == files(tmp_path / "jax") and len(port_files) == sum(stats.values())
    for rel in port_files[::7]:
        a = np.asarray(Image.open(tmp_path / "port" / rel))
        b = np.asarray(Image.open(tmp_path / "jax" / rel))
        np.testing.assert_array_equal(a, b, err_msg=rel)
    img = Image.fromarray(np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3))
    for (k1, v1), (k2, v2) in zip(prepare_data.dih4_variants(img), jax_prepare.dih4_variants(img)):
        assert k1 == k2 and np.array_equal(np.asarray(v1), np.asarray(v2))


def test_launcher_matches_jax(tmp_path):
    sweep = {"num_inference_steps": [5, 10], "method": ["ddib"]}
    assert launcher.expand_sweep(sweep) == jax_launcher.expand_sweep(sweep)
    cmd = launcher.build_command("c.yaml", ["k=v"], debug=True)
    want = jax_launcher.build_command("c.yaml", ["k=v"], debug=True)
    assert cmd == [w.replace("phendiff_tpu.cli", "phendiff_tpu_torch.cli") for w in want]
    assert (launcher.sbatch_script(cmd, "j", True, "a@b")
            == jax_launcher.sbatch_script(cmd, "j", True, "a@b"))

    conf = tmp_path / "c.yaml"
    conf.write_text(yaml.safe_dump({"output_dir": "x"}))
    (tmp_path / "s.yaml").write_text(yaml.safe_dump(sweep))
    scripts = {}
    for name, main in (("port", launcher.main), ("jax", jax_launcher.main)):
        exp = tmp_path / name
        assert main(["--config", str(conf), "--experiment_dir", str(exp), "--sweep",
                     str(tmp_path / "s.yaml"), "--slurm", "--dry_run"]) == 0
        assert (exp / "frozen_launch_config.yaml").read_text() == conf.read_text()
        scripts[name] = [(exp / f"job_{i:03d}.sbatch").read_text().replace(str(exp), "EXP")
                         for i in range(2)]
    assert scripts["port"] == [s.replace("phendiff_tpu.cli", "phendiff_tpu_torch.cli")
                               for s in scripts["jax"]]
