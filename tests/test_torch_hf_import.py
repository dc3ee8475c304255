"""The port's diffusers import for the SD family, on the CPU.

* The manifest check: the full SD-2.1 UNet and VAE, built on the meta
  device, against ``tests/fixtures/sd21_manifest.json`` (the published
  checkpoint's key set and shapes, 865,910,724 UNet and 83,653,863 VAE
  parameters): ``import_sd_unet`` / ``import_vae`` map every manifest key,
  no more, onto every parameter of the port's modules with its shape.
* At the tiny configs of ``tests/test_sd_models.py``, a checkpoint the JAX
  package exports (``export_sd_unet`` / ``export_vae``) imports into the
  port as exactly the weights ``models/convert.py`` carries from the same
  Flax tree, and the imported model's output matches.
* The export direction and the pixel UNet: each of the port's exports
  (``export_unet2d``, ``export_sd_unet``, ``export_vae``) of the weights
  ``convert.from_flax_params`` carries equals the JAX package's export of
  the same Flax tree, key for key and bit for bit; ``import_unet2d`` of the
  JAX export gives those weights and the same UNet output; export then
  import is exact; the full SD-2.1 UNet and VAE export the manifest's keys
  and shapes.
"""

import functools
import json
import os

os.environ["PHENDIFF_PALLAS_INTERPRET"] = "1"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from phendiff_tpu.models import CondUNet2D as JaxUNet  # noqa: E402
from phendiff_tpu.models import UNet2DConfig as JaxUNetConfig  # noqa: E402
from phendiff_tpu.models import autoencoder_kl as jax_vae  # noqa: E402
from phendiff_tpu.models import hf_import as jax_hf  # noqa: E402
from phendiff_tpu.models import sd_unet as jax_sd  # noqa: E402
from phendiff_tpu.pipelines.io import flatten_params  # noqa: E402
from phendiff_tpu_torch.models import convert, hf_import  # noqa: E402
from phendiff_tpu_torch.models.autoencoder_kl import AutoencoderKL, AutoencoderKLConfig  # noqa: E402
from phendiff_tpu_torch.models.config import UNet2DConfig  # noqa: E402
from phendiff_tpu_torch.models.sd_unet import SDUNet, SDUNetConfig  # noqa: E402
from phendiff_tpu_torch.models.unet2d import CondUNet2D  # noqa: E402
from phendiff_tpu_torch.pipelines.io import save_safetensors  # noqa: E402

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "sd21_manifest.json")
TINY_SD = dict(
    sample_size=8, block_out_channels=(16, 32),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, cross_attention_dim=24, attention_head_dim=(2, 4), norm_num_groups=4,
)
TINY_VAE = dict(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4,
                latent_channels=4, sample_size=32)
TINY_UNET2D = dict(
    sample_size=8, block_out_channels=(8, 16),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1, norm_num_groups=4, attention_head_dim=4, num_class_embeds=2,
)
FAMILIES = ("unet2d", "sd_unet", "vae")


@functools.cache
def _flax(family):
    """(the JAX config, its Flax variables, the port's config) at a tiny size."""
    if family == "unet2d":
        jcfg = JaxUNetConfig(**TINY_UNET2D)
        return jcfg, JaxUNet(jcfg, lane_pack=False).init(
            jax.random.key(2), jnp.zeros((1, 8, 8, 3)), jnp.array([0]),
            class_labels=jnp.array([0])), UNet2DConfig(**TINY_UNET2D)
    if family == "sd_unet":
        jcfg = jax_sd.SDUNetConfig(**TINY_SD)
        return jcfg, jax_sd.SDUNet(jcfg).init(jax.random.key(0), jnp.zeros((1, 8, 8, 4)),
                                              jnp.array([0]), jnp.zeros((1, 77, 24))), \
            SDUNetConfig(**TINY_SD)
    jcfg = jax_vae.AutoencoderKLConfig(**TINY_VAE)
    return jcfg, jax_vae.AutoencoderKL(jcfg).init(jax.random.key(1), jnp.zeros((1, 32, 32, 3))), \
        AutoencoderKLConfig(**TINY_VAE)


def _exports(family):
    """(the JAX export, the port's export, the port's import)."""
    return {"unet2d": (jax_hf.export_unet2d, hf_import.export_unet2d, hf_import.import_unet2d),
            "sd_unet": (jax_hf.export_sd_unet, hf_import.export_sd_unet,
                        hf_import.import_sd_unet),
            "vae": (jax_hf.export_vae, hf_import.export_vae, hf_import.import_vae)}[family]


@pytest.fixture(scope="module")
def manifest():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.mark.parametrize("part", ["unet", "vae"])
def test_import_matches_sd21_manifest(manifest, part):
    shapes = manifest[part]
    sd = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    if part == "unet":
        cfg, build, imp = SDUNetConfig(), SDUNet, hf_import.import_sd_unet
    else:
        cfg, build, imp = AutoencoderKLConfig(), AutoencoderKL, hf_import.import_vae
    out = imp(sd, cfg)
    with torch.device("meta"):
        model = build(cfg)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in out.items()} == want
    plan = hf_import.sd_unet_plan(cfg) if part == "unet" else hf_import.vae_plan(cfg)
    assert {t for _, t in plan} == set(shapes) and len(plan) == len(shapes)  # one to one
    n = sum(v.numel() for v in out.values())
    assert n == manifest[f"{part}_param_count"]
    assert n == (865_910_724 if part == "unet" else 83_653_863)


def test_import_refuses_a_checkpoint_that_does_not_match(manifest):
    shapes = manifest["vae"]
    sd = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    cfg = AutoencoderKLConfig()
    with pytest.raises(ValueError, match="missing"):
        hf_import.import_vae({k: v for k, v in sd.items() if k != "quant_conv.bias"}, cfg)
    with pytest.raises(ValueError, match="unmapped"):
        hf_import.import_vae(dict(sd, extra_key=torch.empty(1, device="meta")), cfg)
    bad = dict(sd)
    bad["quant_conv.bias"] = torch.empty(9, device="meta")
    with pytest.raises(ValueError, match="quant_conv.bias"):
        hf_import.import_vae(bad, cfg)


def test_jax_exported_unet_imports_as_the_same_weights(tmp_path):
    jcfg = jax_sd.SDUNetConfig(**TINY_SD)
    jmodel = jax_sd.SDUNet(jcfg)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 8, 8, 4)), jnp.array([0]),
                         jnp.zeros((1, 77, 24)))
    exported = jax_hf.export_sd_unet(params, jcfg)
    cfg = SDUNetConfig(**TINY_SD)
    path = str(tmp_path / "unet.safetensors")
    save_safetensors({k: np.asarray(v, dtype=np.float32) for k, v in exported.items()}, path)
    got = hf_import.import_sd_unet(hf_import.load_state_dict(path), cfg)
    want = convert.from_flax_params(flatten_params(params), cfg)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    model = SDUNet(cfg)
    model.load_state_dict(got)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 24)).astype(np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.tensor([500]), torch.from_numpy(ctx))
    np.testing.assert_allclose(out.numpy(), np.asarray(jmodel.apply(
        params, jnp.asarray(x), jnp.array([500]), jnp.asarray(ctx))), atol=1e-4)


def test_jax_exported_vae_imports_as_the_same_weights(tmp_path):
    jcfg = jax_vae.AutoencoderKLConfig(**TINY_VAE)
    variables = jax_vae.AutoencoderKL(jcfg).init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)))
    exported = jax_hf.export_vae(variables, jcfg)
    path = str(tmp_path / "vae.bin")
    torch.save({k: torch.from_numpy(np.array(v)).half() for k, v in exported.items()}, path)
    loaded = hf_import.load_state_dict(path)
    assert all(v.dtype == torch.float32 for v in loaded.values())
    cfg = AutoencoderKLConfig(**TINY_VAE)
    got = hf_import.import_vae(loaded, cfg)
    want = convert.from_flax_params(flatten_params(variables), cfg)
    assert set(got) == set(want)
    for k in want:  # through float16 on disk
        torch.testing.assert_close(got[k], want[k].half().float(), rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_export_matches_the_jax_export(family):
    jcfg, variables, cfg = _flax(family)
    jax_export, export, _ = _exports(family)
    want = jax_export(variables, jcfg)
    got = export(convert.from_flax_params(flatten_params(variables), cfg), cfg)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_export_then_import_is_exact(family):
    _, variables, cfg = _flax(family)
    _, export, imp = _exports(family)
    params = convert.from_flax_params(flatten_params(variables), cfg)
    back = imp(export(params, cfg), cfg)
    assert set(back) == set(params)
    for k in params:
        assert torch.equal(back[k], params[k]), k


def test_jax_exported_unet2d_imports_as_the_same_weights():
    jcfg, variables, cfg = _flax("unet2d")
    got = hf_import.import_unet2d(jax_hf.export_unet2d(variables, jcfg), cfg)
    want = convert.from_flax_params(flatten_params(variables), cfg)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    model = CondUNet2D(cfg)
    model.load_state_dict(got)
    x = np.random.default_rng(1).standard_normal((2, 8, 8, 3)).astype(np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.tensor([10, 700]), torch.tensor([0, 1]))
    want_out = JaxUNet(jcfg, lane_pack=False).apply(
        variables, jnp.asarray(x), jnp.array([10, 700]), class_labels=jnp.array([0, 1]))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-4)


@pytest.mark.parametrize("part", ["unet", "vae"])
def test_export_matches_sd21_manifest(manifest, part):
    cfg, build, export = ((SDUNetConfig(), SDUNet, hf_import.export_sd_unet) if part == "unet"
                          else (AutoencoderKLConfig(), AutoencoderKL, hf_import.export_vae))
    with torch.device("meta"):
        model = build(cfg)
    out = export(model.state_dict(), cfg)
    assert {k: list(v.shape) for k, v in out.items()} == manifest[part]


def test_export_refuses_parameters_that_do_not_match():
    _, variables, cfg = _flax("unet2d")
    params = convert.from_flax_params(flatten_params(variables), cfg)
    with pytest.raises(ValueError, match="missing"):
        hf_import.export_unet2d({k: v for k, v in params.items() if k != "conv_in.bias"}, cfg)
    with pytest.raises(ValueError, match="unmapped"):
        hf_import.export_unet2d(dict(params, extra=torch.zeros(1)), cfg)
    sd = hf_import.export_unet2d(params, cfg)
    with pytest.raises(ValueError, match="missing"):
        hf_import.import_unet2d({k: v for k, v in sd.items()
                                 if k != "mid_block.attentions.0.to_k.weight"}, cfg)
