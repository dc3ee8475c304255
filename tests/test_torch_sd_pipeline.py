"""The SD class-transfer slice on the CPU: the port's ``SDImg2ImgPipeline``
and the comparison engine's SD route against the JAX package's.

A tiny JAX ``SDImg2ImgPipeline`` (the configs of ``tests/test_sd_pipeline.py``)
is saved by the JAX package and loaded by the port, and a folder the port
saves is loaded by the JAX package.  Latents, images and noise come from
numpy and go to both sides, float32.  ``generate`` and ``invert`` are held
against the JAX pipeline per denoiser call (each call's output against the
JAX UNet on the same input) and whole, at 1e-4 of the output's largest
magnitude (float32 in another order, through a few DDIM steps).  The engine
runs all four methods at 2 steps over a 32 px folder beside the JAX engine:
the same output tree and metric keys, and the deterministic methods' PNGs
within one uint8 level.
"""

import json
import os

os.environ["PHENDIFF_PALLAS_INTERPRET"] = "1"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import yaml  # noqa: E402
from PIL import Image  # noqa: E402

from phendiff_tpu.core import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from phendiff_tpu.experiments import comparison as jax_comparison  # noqa: E402
from phendiff_tpu.metrics.inception import InceptionExtractor as JaxInceptionExtractor  # noqa: E402
from phendiff_tpu.metrics.inception import InceptionV3 as JaxInceptionV3  # noqa: E402
from phendiff_tpu.metrics.inception import convert_torch_weights  # noqa: E402
from phendiff_tpu.models.autoencoder_kl import AutoencoderKLConfig as JaxVAEConfig  # noqa: E402
from phendiff_tpu.models.sd_unet import SDUNetConfig as JaxSDConfig  # noqa: E402
from phendiff_tpu.pipelines.io import flatten_params  # noqa: E402
from phendiff_tpu.pipelines.sd_img2img import SDImg2ImgPipeline as JaxSDPipeline  # noqa: E402
from phendiff_tpu_torch.experiments import comparison  # noqa: E402
from phendiff_tpu_torch.models.convert import to_flax_params  # noqa: E402
from phendiff_tpu_torch.pipelines.sd_img2img import SDImg2ImgPipeline  # noqa: E402

torch.set_num_threads(1)

TINY_SD = dict(
    sample_size=4, block_out_channels=(16, 32),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, cross_attention_dim=16, attention_head_dim=(2, 4), norm_num_groups=4,
)
TINY_VAE = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4,
                latent_channels=4, sample_size=32)
SCHED = JaxSchedulerConfig(num_train_timesteps=50, timestep_spacing="leading",
                           clip_sample=False, set_alpha_to_one=False, steps_offset=1)
REL_TOL = 1e-4  # of the output's largest magnitude
METHODS = ["ddib", "inverted_regeneration", "classifier_free_guidance_forward_start",
           "linear_interp_custom_guidance_inverted_start"]
METRICS = {"fid": False, "isc": True, "kid": True, "kid_subset_size": 2, "kid_subsets": 3}


def _close(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=REL_TOL * max(np.abs(want).max(), 1.0))


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    root = tmp_path_factory.mktemp("sd")
    jpipe = JaxSDPipeline.init_random(JaxSDConfig(**TINY_SD), JaxVAEConfig(**TINY_VAE), SCHED,
                                      num_classes=2, class_embedding_dim=16, seed=0)
    jpipe.save_pretrained(str(root / "jax_pipe"))
    return jpipe, SDImg2ImgPipeline.from_pretrained(str(root / "jax_pipe"), device="cpu"), root


def _recording(tpipe, monkeypatch):
    """Record every denoiser call of the port's pipeline: (x, t, seq, out)."""
    calls, den = [], tpipe.denoiser_fn()

    def rec(x, t, seq):
        out = den(x, t, seq)
        calls.append((x.clone(), t.clone(), seq.clone(), out.clone()))
        return out

    monkeypatch.setattr(tpipe, "denoiser_fn", lambda: rec)
    return calls


def _check_calls(jpipe, calls):
    assert calls
    for x, t, seq, out in calls:
        want = jpipe.unet.apply(jpipe.unet_params, jnp.asarray(x.numpy()),
                                jnp.asarray(t.numpy()), jnp.asarray(seq.numpy()))
        _close(out.numpy(), want)


def test_jax_folder_loads_and_port_folder_loads_in_jax(pipes):
    jpipe, tpipe, root = pipes
    assert tpipe.unet_config.to_json_dict() == jpipe.unet_config.to_json_dict()
    assert tpipe.vae_config.to_json_dict() == jpipe.vae_config.to_json_dict()
    assert (tpipe.num_classes, tpipe.class_embedding_dim) == (2, 16)
    tpipe.save_pretrained(str(root / "port"))
    back = JaxSDPipeline.from_pretrained(str(root / "port"))
    assert back.unet_config == jpipe.unet_config and back.vae_config == jpipe.vae_config
    for name, tree in (("unet", "unet_params"), ("vae", "vae_params"),
                       ("class_embedding", "class_embedding_params")):
        want = flatten_params(getattr(jpipe, tree))
        got = flatten_params(getattr(back, tree))
        assert set(got) == set(want), name
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    with open(root / "port" / "model_index.json") as f:
        assert json.load(f)["_class_name"] == "SDImg2ImgPipeline"


def test_encode_class_and_prepare_latents(pipes):
    jpipe, tpipe, _ = pipes
    seq = tpipe.encode_class(torch.tensor([0, 1]))
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jpipe.encode_class(jnp.array([0, 1]))))
    assert seq.shape == (2, 77, 16) and not seq[:, 1:].any()
    # no image: noise at the latent shape, drawn from the generator
    noise = tpipe.prepare_latents(None, 3, torch.Generator().manual_seed(1))
    torch.testing.assert_close(noise, torch.randn(3, 4, 4, 4,
                                                  generator=torch.Generator().manual_seed(1)))
    # 4 channels: already latents
    lat = torch.randn(2, 4, 4, 4)
    assert tpipe.prepare_latents(lat, 2, None) is lat
    # 3 channels: VAE posterior mean x scaling_factor, as the JAX package's
    img = (np.random.default_rng(2).standard_normal((2, 32, 32, 3)) * 0.5).astype(np.float32)
    _close(tpipe.encode_images(torch.from_numpy(img)).numpy(),
           jpipe.encode_images(jnp.asarray(img)))
    # with a generator the posterior is sampled: mean + std * noise, scaled
    mean, logvar = tpipe.vae.encode(torch.from_numpy(img))
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(3))
    want = (mean + torch.exp(0.5 * logvar) * noise) * tpipe.vae_config.scaling_factor
    got = tpipe.prepare_latents(torch.from_numpy(img), 2, torch.Generator().manual_seed(3))
    torch.testing.assert_close(got, want.detach())


@pytest.mark.parametrize("guidance_scale", [0.0, 3.0], ids=["plain", "cfg_batched"])
def test_generate_matches_jax_per_denoiser_call(pipes, monkeypatch, guidance_scale):
    jpipe, tpipe, _ = pipes
    lat = np.random.default_rng(4).standard_normal((2, 4, 4, 4)).astype(np.float32)
    calls = _recording(tpipe, monkeypatch)
    images, out = tpipe.generate(torch.tensor([0, 1]), None, latents=torch.from_numpy(lat),
                                 num_inference_steps=3, guidance_scale=guidance_scale,
                                 output_type="image+latent")
    assert len(calls) == 3 and calls[0][0].shape[0] == (4 if guidance_scale else 2)
    if guidance_scale:  # cond + uncond in one pass, the uncond sequence zeros
        assert not calls[0][2][2:].any() and calls[0][2][:2].any()
    _check_calls(jpipe, calls)
    jimages, jout = jpipe.generate(jnp.array([0, 1]), jax.random.key(0), latents=jnp.asarray(lat),
                                   num_inference_steps=3, guidance_scale=guidance_scale,
                                   output_type="image+latent")
    _close(out.numpy(), jout)
    assert images.dtype == torch.float32 and images.shape == (2, 32, 32, 3)
    _close(images.numpy(), jimages)
    latent_only = tpipe.generate(torch.tensor([0, 1]), None, latents=torch.from_numpy(lat),
                                 num_inference_steps=3, guidance_scale=guidance_scale,
                                 output_type="latent")
    torch.testing.assert_close(latent_only, out, rtol=0, atol=0)


def test_generate_strength_truncates_by_count(pipes, monkeypatch):
    jpipe, tpipe, _ = pipes
    lat = np.random.default_rng(5).standard_normal((1, 4, 4, 4)).astype(np.float32)
    calls = _recording(tpipe, monkeypatch)
    out = tpipe.generate(torch.tensor([1]), None, image=torch.from_numpy(lat), strength=0.5,
                         num_inference_steps=4, output_type="latent")
    assert len(calls) == 2  # int(0.5 * 4) steps, the low-noise tail
    _check_calls(jpipe, calls)
    want = jpipe.generate(jnp.array([1]), jax.random.key(1), image=jnp.asarray(lat),
                          strength=0.5, num_inference_steps=4, output_type="latent")
    _close(out.numpy(), want)


def test_invert_matches_jax_per_denoiser_call(pipes, monkeypatch):
    jpipe, tpipe, _ = pipes
    img = (np.random.default_rng(6).standard_normal((2, 32, 32, 3)) * 0.5).astype(np.float32)
    calls = _recording(tpipe, monkeypatch)
    got = tpipe.invert(torch.from_numpy(img), torch.tensor([1, 0]), num_inference_steps=3)
    assert len(calls) == 3
    _check_calls(jpipe, calls)
    _close(got.numpy(), jpipe.invert(jnp.asarray(img), jnp.array([1, 0]), num_inference_steps=3))


def test_init_random_cast_and_replace_params():
    from phendiff_tpu_torch.core.scheduler import SchedulerConfig
    from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKLConfig
    from phendiff_tpu_torch.models.sd_unet import SDUNetConfig

    args = (SDUNetConfig(**TINY_SD), AutoencoderKLConfig(**TINY_VAE),
            SchedulerConfig.from_json(SCHED.to_json_dict()))
    a = SDImg2ImgPipeline.init_random(*args, num_classes=2, class_embedding_dim=16, seed=3,
                                      device="cpu")
    b = SDImg2ImgPipeline.init_random(*args, num_classes=2, class_embedding_dim=16, seed=3,
                                      device="cpu")
    for x, y in ((a.unet, b.unet), (a.vae, b.vae), (a.class_embedding, b.class_embedding)):
        for (k, v), w in zip(x.state_dict().items(), y.state_dict().values()):
            torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)
    assert float(a.unet.down_0_attn_0.block_0.norm1.scale.detach().min()) == 1.0
    assert float(a.unet.conv_in.weight.detach().std()) > 0
    half = a.cast_params(torch.bfloat16)
    assert half.unet.conv_in.weight.dtype == torch.bfloat16
    assert half.vae.decoder.conv_out.weight.dtype == torch.bfloat16
    assert half.unet.norm_out_scale.dtype == torch.float32
    assert a.unet.conv_in.weight.dtype == torch.float32  # a copy
    other = b.class_embedding.state_dict()
    other["embedding.weight"] = other["embedding.weight"] + 1
    c = a.replace_params(class_embedding_params=other)
    assert torch.equal(c.class_embedding.embedding.weight, other["embedding.weight"])
    assert not torch.equal(a.class_embedding.embedding.weight, other["embedding.weight"])
    assert c.unet is a.unet
    with a.frozen():
        assert not any(p.requires_grad for p in a.vae.parameters())
    assert all(p.requires_grad for p in a.unet.parameters())


@pytest.fixture(scope="module")
def folder(pipes):
    _, _, root = pipes
    rng = np.random.default_rng(7)
    for cls in ("DMSO", "drug"):
        (root / "data" / cls).mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
                root / "data" / cls / f"img_{i}.png")
    return root


def _conf(root, out):
    return {
        "output_dir": str(root / out), "pipelines": {"sd": str(root / "jax_pipe")},
        "dataset_train": str(root / "data"), "definition": [32, 32], "methods": METHODS,
        "method_params": {m: {"batch_size": 4, "guidance_loss_scale": 1e-2} for m in METHODS},
        "num_inference_steps": 2, "metrics": METRICS, "inference_param_dtype": None,
    }


def test_engine_sd_route_matches_jax_engine(folder, monkeypatch):
    monkeypatch.setenv("PHENDIFF_INCEPTION_RESIZE", "75")
    exp = comparison.ComparisonExperiment(comparison.ComparisonConfig.from_dict(
        _conf(folder, "out_port")), device="cpu")
    assert isinstance(exp.pipes["sd"], SDImg2ImgPipeline)
    port_sd = {k: v.numpy() for k, v in exp.extractor.model.state_dict().items()}

    def jax_extractor():  # the port's seeded weights, random-init semantics
        ext = JaxInceptionExtractor.__new__(JaxInceptionExtractor)
        ext.model, ext.pretrained = JaxInceptionV3(), False
        ext.variables = convert_torch_weights(port_sd)
        ext._apply = jax.jit(lambda x: ext.model.apply(ext.variables, x))
        return ext

    monkeypatch.setattr(jax_comparison, "InceptionExtractor", jax_extractor)
    (folder / "conf.yaml").write_text(yaml.safe_dump(_conf(folder, "out_jax")))
    jexp = jax_comparison.ComparisonExperiment(
        jax_comparison.ComparisonConfig.from_yaml(str(folder / "conf.yaml")),
        devices=jax.devices()[:1])
    want = jexp.run()
    got = exp.run()
    port, ref = folder / "out_port", folder / "out_jax"
    tree = sorted(os.path.relpath(os.path.join(d, f), port)
                  for d, _, files in os.walk(port) for f in files)
    assert tree == sorted(os.path.relpath(os.path.join(d, f), ref)
                          for d, _, files in os.walk(ref) for f in files)
    assert len([f for f in tree if "_to_" in f]) == 4 * len(METHODS)
    for f in tree:
        # cfg draws its forward noise from each package's own generator
        if f.endswith(".png") and not f.startswith("classifier_free"):
            a = np.asarray(Image.open(port / f), dtype=np.int16)
            b = np.asarray(Image.open(ref / f), dtype=np.int16)
            assert np.abs(a - b).max() <= 1, f
    assert sorted(got) == sorted(want) and all(np.isfinite(v) for v in got.values())
    assert "linear_interp_custom_guidance_inverted_start/sd/train/drug/" \
           "kernel_inception_distance_mean" in got


def test_engine_refuses_the_tpu_only_sd_routes(folder, monkeypatch):
    """``segmented_sd: true`` and ``pipeline_parallel: true`` (no card here:
    the segmented route on this device) run the four methods through the
    UNet's stages: the same PNGs as the one-module route, bit-equal where no
    gradient is taken and within one uint8 level for the guided method
    (per-stage input VJPs sum in another order).  Under data parallelism,
    where each rank owns one card, pipeline placement is refused."""
    conf = dict(_conf(folder, "one_module"), metrics={"fid": False, "isc": False, "kid": False})
    comparison.ComparisonExperiment(comparison.ComparisonConfig.from_dict(conf),
                                    device="cpu").run_transfers()
    made = []
    real = comparison._make_segmented_transfer_fn
    monkeypatch.setattr(comparison, "_make_segmented_transfer_fn",
                        lambda *a, **kw: made.append(a[1]) or real(*a, **kw))
    ref = folder / "one_module"
    for key in ("segmented_sd", "pipeline_parallel"):
        made.clear()
        exp = comparison.ComparisonExperiment(comparison.ComparisonConfig.from_dict(
            dict(conf, output_dir=str(folder / key), **{key: True})), device="cpu")
        assert exp.segmented
        exp.run_transfers()
        assert made == METHODS
        out = folder / key
        pngs = sorted(os.path.relpath(os.path.join(d, f), out)
                      for d, _, fs in os.walk(out) for f in fs if f.endswith(".png"))
        assert len([f for f in pngs if "_to_" in f]) == 4 * len(METHODS)
        for f in pngs:
            a = np.asarray(Image.open(out / f), dtype=np.int16)
            b = np.asarray(Image.open(ref / f), dtype=np.int16)
            levels = 1 if f.startswith("linear_interp") else 0
            assert np.abs(a - b).max() <= levels, (key, f)
    monkeypatch.setattr(comparison, "data_size", lambda: 2)
    with pytest.raises(ValueError, match="each rank owns one card"):
        comparison.ComparisonExperiment(comparison.ComparisonConfig.from_dict(
            dict(conf, pipeline_parallel=True)), device="cpu")


def test_engine_casts_sd_pipelines_to_inference_dtype(folder):
    conf = dict(_conf(folder, "y"))
    del conf["inference_param_dtype"]  # the default: bf16 weights and compute
    pipe = comparison.ComparisonExperiment(comparison.ComparisonConfig.from_dict(conf),
                                           device="cpu").pipes["sd"]
    assert pipe.dtype == torch.bfloat16 and pipe.vae.dtype == torch.bfloat16
    assert pipe.unet.conv_in.weight.dtype == torch.bfloat16
    assert set(to_flax_params(pipe.class_embedding.state_dict())) == {
        "params/embedding/embedding"}
