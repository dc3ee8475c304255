"""The port's CondUNet2D and weight carry-over against the JAX package's
``CondUNet2D(lane_pack=False)``.

Same Flax weights (converted by ``from_flax_params``) and the same numpy
inputs on both sides, float32 compute.  Tolerance: atol 1e-4 on outputs of
order 1 (float32 convolutions summed in a different order, over a few
dozen layers).
"""

import os

os.environ["PHENDIFF_PALLAS_INTERPRET"] = "1"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from phendiff_tpu.models import CondUNet2D as JaxUNet  # noqa: E402
from phendiff_tpu.models import UNet2DConfig as JaxConfig  # noqa: E402
from phendiff_tpu.pipelines.io import flatten_params  # noqa: E402
from phendiff_tpu_torch.models import convert  # noqa: E402
from phendiff_tpu_torch.models.config import UNet2DConfig  # noqa: E402
from phendiff_tpu_torch.models.embeddings import sinusoidal_timestep_embedding  # noqa: E402
from phendiff_tpu_torch.models.unet2d import CondUNet2D  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-4
TINY = dict(
    sample_size=16, block_out_channels=(8, 16),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1, norm_num_groups=4, attention_head_dim=4, num_class_embeds=2,
)
VARIANTS = {
    "default": {},
    "scale_shift_pad0": dict(resnet_time_scale_shift="scale_shift", downsample_padding=0),
    "fourier_centered": dict(time_embedding_type="fourier", center_input_sample=True,
                             mid_block_scale_factor=1.5, attention_head_dim=None,
                             flip_sin_to_cos=False),
}


def _pair(variant):
    kw = {**TINY, **VARIANTS[variant]}
    jmodel = JaxUNet(JaxConfig(**kw), lane_pack=False)
    params = jmodel.init(jax.random.key(3), jnp.zeros((1, 16, 16, 3)), jnp.array([0]),
                         class_labels=jnp.array([0]))
    cfg = UNet2DConfig(**kw)
    tmodel = CondUNet2D(cfg)
    tmodel.load_state_dict(convert.from_flax_params(flatten_params(params), cfg))
    return jmodel, params, tmodel


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_flax_round_trip(variant):
    _, params, tmodel = _pair(variant)
    flat = flatten_params(params)
    back = convert.to_flax_params(tmodel.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax_f32(variant):
    jmodel, params, tmodel = _pair(variant)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([0, 731])
    emb = rng.standard_normal((2, 32)).astype(np.float32)
    want = jmodel.apply(params, jnp.asarray(x), jnp.asarray(t), class_emb=jnp.asarray(emb))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t), class_emb=torch.from_numpy(emb))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # integer labels embed through the class table
    labels = np.array([1, 0])
    want = jmodel.apply(params, jnp.asarray(x), 17, class_labels=jnp.asarray(labels))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), 17, class_labels=torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_sinusoidal_embedding_matches_jax():
    from phendiff_tpu.models.embeddings import sinusoidal_timestep_embedding as jax_emb

    t = np.array([0, 1, 500, 999])
    for kw in (dict(flip_sin_to_cos=True, freq_shift=0.0), dict(flip_sin_to_cos=False,
                                                                 freq_shift=1.0)):
        want = jax_emb(jnp.asarray(t), 33, **kw)
        got = sinusoidal_timestep_embedding(torch.from_numpy(t), 33, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_converter_rejects_mismatched_checkpoint():
    _, params, _ = _pair("default")
    flat = flatten_params(params)
    cfg = UNet2DConfig(**TINY)
    with pytest.raises(ValueError, match="missing"):
        convert.from_flax_params({k: v for k, v in flat.items() if "mid_attn" not in k}, cfg)
    with pytest.raises(ValueError, match="shape"):
        convert.from_flax_params(flat, UNet2DConfig(**{**TINY, "block_out_channels": (8, 24)}))


def test_bf16_compute_keeps_norm_params_f32():
    from phendiff_tpu_torch.core.precision import cast_matmul_weights

    model = cast_matmul_weights(CondUNet2D(UNet2DConfig(**TINY), dtype=torch.bfloat16))
    model.init_weights(torch.Generator().manual_seed(0))
    assert model.conv_in.weight.dtype == torch.bfloat16
    assert model.mid_attn.qkv.weight.dtype == torch.bfloat16
    assert model.mid_attn.norm_scale.dtype == torch.float32
    assert model.class_embedding.weight.dtype == torch.float32
    assert model.conv_in.weight.is_contiguous(memory_format=torch.channels_last)
    x = torch.randn(2, 16, 16, 3)
    with torch.no_grad():
        out = model(x, torch.tensor([3, 4]), class_labels=torch.tensor([0, 1]))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
