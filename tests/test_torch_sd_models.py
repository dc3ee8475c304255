"""The port's SD family modules against the JAX package's, on the CPU.

``SDUNet``, ``Transformer2D``, ``GEGLUFeedForward``, the VAE's encode and
decode, ``ClassEmbedding`` and ``pad_to_clip_sequence`` at the tiny configs
of ``tests/test_sd_models.py``, float32, the same Flax weights on both
sides (carried across by ``models/convert.py``) and the same numpy inputs
from a seed.  Tolerance: atol 1e-4 on outputs of order 1 (float32 sums in
another order over a few dozen layers), as ``tests/test_torch_unet.py``.
"""

import os

os.environ["PHENDIFF_PALLAS_INTERPRET"] = "1"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from phendiff_tpu.models import autoencoder_kl as jax_vae  # noqa: E402
from phendiff_tpu.models import embeddings as jax_emb  # noqa: E402
from phendiff_tpu.models import sd_unet as jax_sd  # noqa: E402
from phendiff_tpu.pipelines.io import flatten_params  # noqa: E402
from phendiff_tpu_torch.models import autoencoder_kl, convert, sd_unet  # noqa: E402
from phendiff_tpu_torch.models.embeddings import ClassEmbedding, pad_to_clip_sequence  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-4
TINY_SD = dict(
    sample_size=8, block_out_channels=(16, 32),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, cross_attention_dim=24, attention_head_dim=(2, 4), norm_num_groups=4,
)
SD_VARIANTS = {
    "linear": {},
    "conv_projection": dict(use_linear_projection=False, attention_head_dim=2,
                            flip_sin_to_cos=False, freq_shift=1.0),
}
TINY_VAE = dict(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4,
                latent_channels=4, sample_size=32)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _load(module, params):
    module.load_state_dict(convert.from_flax_params(flatten_params(params), module))
    return module


@pytest.fixture(scope="module", params=sorted(SD_VARIANTS))
def sd_pair(request):
    kw = {**TINY_SD, **SD_VARIANTS[request.param]}
    jcfg = jax_sd.SDUNetConfig(**kw)
    jmodel = jax_sd.SDUNet(jcfg)
    params = jmodel.init(jax.random.key(0), jnp.zeros((2, 8, 8, 4)), jnp.array([0, 1]),
                         jnp.zeros((2, 77, 24)))
    cfg = sd_unet.SDUNetConfig(**kw)
    tmodel = sd_unet.SDUNet(cfg)
    tmodel.load_state_dict(convert.from_flax_params(flatten_params(params), cfg))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def vae_pair():
    jmodel = jax_vae.AutoencoderKL(jax_vae.AutoencoderKLConfig(**TINY_VAE))
    variables = jmodel.init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)))
    cfg = autoencoder_kl.AutoencoderKLConfig(**TINY_VAE)
    tmodel = autoencoder_kl.AutoencoderKL(cfg)
    tmodel.load_state_dict(convert.from_flax_params(flatten_params(variables), cfg))
    return jmodel, variables, tmodel


def test_sd_unet_flax_round_trip(sd_pair):
    _, params, tmodel = sd_pair
    flat = flatten_params(params)
    back = convert.to_flax_params(tmodel.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


def test_sd_unet_matches_jax_f32(sd_pair):
    jmodel, params, tmodel = sd_pair
    rng = _rng(1)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([0, 731])
    ctx = rng.standard_normal((2, 77, 24)).astype(np.float32)
    want = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # a scalar timestep broadcasts over the batch
    with torch.no_grad():
        scalar = tmodel(torch.from_numpy(x), 731, torch.from_numpy(ctx))
        batch = tmodel(torch.from_numpy(x), torch.tensor([731, 731]), torch.from_numpy(ctx))
    torch.testing.assert_close(scalar, batch, rtol=0, atol=0)


@pytest.mark.parametrize("use_linear", [True, False], ids=["linear", "conv"])
def test_transformer2d_matches_jax(use_linear):
    jmod = jax_sd.Transformer2D(num_heads=2, head_dim=8, norm_num_groups=4,
                                use_linear_projection=use_linear)
    rng = _rng(2)
    x = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 12)).astype(np.float32)
    params = jmod.init(jax.random.key(3), jnp.asarray(x), jnp.asarray(ctx))
    # non-trivial norm params, so a swapped scale/bias would show
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape) / v.size
        if "norm" in jax.tree_util.keystr(p) else v, params)
    want = jmod.apply(params, jnp.asarray(x), jnp.asarray(ctx))
    tmod = _load(sd_unet.Transformer2D(16, 12, 2, 8, norm_num_groups=4,
                                       use_linear_projection=use_linear), params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_geglu_feed_forward_uses_tanh_gelu_as_jax():
    jmod = jax_sd.GEGLUFeedForward()
    x = _rng(4).standard_normal((2, 5, 16)).astype(np.float32) * 2
    params = jmod.init(jax.random.key(5), jnp.asarray(x))
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    tmod = _load(sd_unet.GEGLUFeedForward(16), params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the exact erf GELU (diffusers') would differ by more than the tolerance
    h, gate = tmod.proj_in(torch.from_numpy(x)).chunk(2, dim=-1)
    with torch.no_grad():
        erf = tmod.proj_out(h * torch.nn.functional.gelu(gate)).numpy()
    assert np.abs(erf - want).max() > 10 * ATOL


def test_vae_encode_decode_match_jax(vae_pair):
    jmodel, variables, tmodel = vae_pair
    x = (_rng(6).standard_normal((2, 32, 32, 3)) * 0.5).astype(np.float32)
    mean, logvar = jmodel.apply(variables, jnp.asarray(x), method=jax_vae.AutoencoderKL.encode)
    with torch.no_grad():
        tmean, tlogvar = tmodel.encode(torch.from_numpy(x))
    assert tmean.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(mean), atol=ATOL)
    np.testing.assert_allclose(tlogvar.numpy(), np.asarray(logvar), atol=ATOL)
    want = jmodel.apply(variables, mean, method=jax_vae.AutoencoderKL.decode)
    with torch.no_grad():
        got = tmodel.decode(torch.from_numpy(np.array(mean)))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the scaled helpers: x scaling_factor on encode, / on decode
    lat = jax_vae.encode_to_latents(jmodel, variables, jnp.asarray(x))
    with torch.no_grad():
        tlat = autoencoder_kl.encode_to_latents(tmodel, torch.from_numpy(x))
        img = autoencoder_kl.decode_from_latents(tmodel, tlat)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(lat), atol=ATOL)
    np.testing.assert_allclose(
        img.numpy(), np.asarray(jax_vae.decode_from_latents(jmodel, variables, lat)), atol=ATOL)


def test_vae_flax_round_trip_and_logvar_clip(vae_pair):
    _, variables, tmodel = vae_pair
    flat = flatten_params(variables)
    back = convert.to_flax_params(tmodel.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    model = autoencoder_kl.AutoencoderKL(autoencoder_kl.AutoencoderKLConfig(**TINY_VAE))
    with torch.no_grad():
        model.quant_conv.bias[4:] = torch.tensor([100.0, -100.0, 0.0, 5.0])
        _, logvar = model.encode(torch.zeros(1, 32, 32, 3))
    assert float(logvar[..., 0].max()) == 20.0 and float(logvar[..., 1].min()) == -30.0


def test_sample_gaussian_with_injected_noise():
    rng = _rng(7)
    mean, logvar = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    gen = torch.Generator().manual_seed(11)
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(11))
    got = autoencoder_kl.sample_gaussian(torch.from_numpy(mean), torch.from_numpy(logvar), gen)
    # the JAX function's arithmetic on the same noise
    key = jax.random.key(0)
    jax_noise = jax.random.normal(key, mean.shape)
    want_jax = jax_vae.sample_gaussian(jnp.asarray(mean), jnp.asarray(logvar), key)
    np.testing.assert_allclose(np.asarray(want_jax),
                               mean + np.exp(0.5 * logvar) * np.asarray(jax_noise), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), mean + np.exp(0.5 * logvar) * noise.numpy(),
                               atol=1e-6)


def test_class_embedding_and_clip_sequence_match_jax():
    jmod = jax_emb.ClassEmbedding(3, 16)
    params = jmod.init(jax.random.key(8), jnp.array([0]))
    labels = np.array([2, 0, 1])
    want = np.asarray(jax_emb.pad_to_clip_sequence(jmod.apply(params, jnp.asarray(labels))))
    tmod = _load(ClassEmbedding(3, 16), params)
    assert set(convert.to_flax_params(tmod.state_dict())) == {"params/embedding/embedding"}
    with torch.no_grad():
        got = pad_to_clip_sequence(tmod(torch.from_numpy(labels)))
    assert got.shape == (3, 77, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_configs_round_trip_json_as_jax():
    for kw in (TINY_SD, {}):
        want = jax_sd.SDUNetConfig(**kw).to_json_dict()
        cfg = sd_unet.SDUNetConfig.from_json(want)
        assert cfg.to_json_dict() == want
    full = sd_unet.SDUNetConfig()
    assert full.upcast_attention and [full.block_out_channels[i] // full.heads_at(i)
                                      for i in range(4)] == [64] * 4
    raw = dict(full.to_json_dict(), act_fn="silu", upcast_attention=False)
    assert sd_unet.SDUNetConfig.from_json(raw).upcast_attention is False
    with pytest.raises(ValueError, match="unsupported SD UNet config key"):
        sd_unet.SDUNetConfig.from_json(dict(raw, no_such_key=1))
    vae = jax_vae.AutoencoderKLConfig(**TINY_VAE).to_json_dict()
    assert autoencoder_kl.AutoencoderKLConfig.from_json(vae).to_json_dict() == vae
    with pytest.raises(ValueError, match="unsupported VAE config key"):
        autoencoder_kl.AutoencoderKLConfig.from_json(dict(vae, no_such_key=1))
