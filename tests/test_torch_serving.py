"""The port's serving engine on the CPU: every case of ``tests/test_serving.py``
on ``phendiff_tpu_torch.serving``, and the engine held against the JAX
package's ``InferenceEngine`` for the same weights and inputs.

A tiny JAX pipeline is saved by the JAX package and loaded by the port.
Images come from numpy in [0, 1] and go to both engines, float32.  Both
run the same float32 arithmetic in another order, and the images leave
through the clip to [0, 1]: ``transfer`` and ``generate`` agree to 1e-5
absolute.  ``invert`` returns raw latents, held at 1e-5 of their largest
magnitude.  The SD route adds a VAE encode and decode around the latent
DDIB; its images agree to 1e-4, the tolerance of the SD pipeline's parity
tests (``tests/test_torch_sd_pipeline.py``).  ``generate`` draws its start
noise from the port's seeded ``torch.Generator``, so the JAX side is the
pipeline's ``generate`` with ``start_image=`` that noise.  On the CPU the engine captures nothing: each
request runs the op function eagerly (the card's graphs are tested in
``tests/test_torch_serving_cuda.py``).
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
from phendiff_tpu.models import UNet2DConfig as JaxUNetConfig  # noqa: E402
from phendiff_tpu.models.autoencoder_kl import AutoencoderKLConfig as JaxVAEConfig  # noqa: E402
from phendiff_tpu.models.sd_unet import SDUNetConfig as JaxSDConfig  # noqa: E402
from phendiff_tpu.pipelines import ConditionalDDIMPipeline as JaxPipeline  # noqa: E402
from phendiff_tpu.pipelines.sd_img2img import SDImg2ImgPipeline as JaxSDPipeline  # noqa: E402
from phendiff_tpu.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from phendiff_tpu.serving import InferenceEngine as JaxEngine  # noqa: E402
from phendiff_tpu_torch.core.scheduler import SchedulerConfig  # noqa: E402
from phendiff_tpu_torch.models.config import UNet2DConfig  # noqa: E402
from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline  # noqa: E402
from phendiff_tpu_torch.pipelines.sd_img2img import SDImg2ImgPipeline  # noqa: E402
from phendiff_tpu_torch.serving import EngineConfig, InferenceEngine  # noqa: E402

torch.set_num_threads(1)

TINY = dict(
    sample_size=8,
    block_out_channels=(8, 8),
    down_block_types=("DownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "UpBlock2D"),
    layers_per_block=1,
    norm_num_groups=4,
    num_class_embeds=2,
)
SCHED = dict(num_train_timesteps=20, clip_sample=False)
CONFIG = dict(max_batch=8, num_inference_steps=4)
IMAGE_ATOL = 1e-5
SD_IMAGE_ATOL = 1e-4
REL_TOL = 1e-5  # of the raw latents' largest magnitude


def _port_pipe(seed=0):
    return ConditionalDDIMPipeline.init_random(
        UNet2DConfig(**TINY), SchedulerConfig(**SCHED), seed=seed, device="cpu")


@pytest.fixture(scope="module")
def engine():
    eng = InferenceEngine(_port_pipe(), EngineConfig(**CONFIG))
    times = eng.warmup()
    assert set(times) == {"generate", "transfer", "invert"}
    return eng


@pytest.fixture(scope="module")
def jax_pair(tmp_path_factory):
    """A JAX pipeline, the port's load of its saved folder, and a JAX engine
    with the transfer and invert ops."""
    jpipe = JaxPipeline.init_random(JaxUNetConfig(**TINY), JaxSchedulerConfig(**SCHED), seed=3)
    jpipe = dataclasses.replace(jpipe, lane_pack=False)
    path = str(tmp_path_factory.mktemp("serving"))
    jpipe.save_pretrained(path)
    jeng = JaxEngine(jpipe, JaxEngineConfig(**CONFIG, ops=("transfer", "invert")))
    jeng.warmup()
    return jpipe, jeng, ConditionalDDIMPipeline.from_pretrained(path, device="cpu")


def _images(k, seed=0, shape=(8, 8, 3)):
    return np.random.default_rng(seed).random((k,) + shape).astype(np.float32)


# -- the cases of tests/test_serving.py ---------------------------------------


def test_generate_partial_batch(engine):
    out = engine.generate(np.array([0, 1, 0]), seed=1)
    assert out.shape == (3, 8, 8, 3)
    assert out.min() >= 0.0 and out.max() <= 1.0


def test_generate_padding_invariance(engine):
    """Results for a request must not depend on the padding rows."""
    a = engine.generate(np.array([0, 1]), seed=2)
    b = engine.generate(np.array([0, 1, 1, 1]), seed=2)
    np.testing.assert_allclose(a, b[:2], atol=1e-5)


def test_transfer_binary_flip_default(engine):
    imgs = engine.generate(np.array([0, 0]), seed=3)
    out = engine.transfer(imgs, np.array([0, 0]))
    assert out.shape == imgs.shape
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out, engine.transfer(imgs, np.array([0, 0]), np.array([1, 1])))


def test_invert_shape(engine):
    imgs = engine.generate(np.array([1]), seed=4)
    lat = engine.invert(imgs, np.array([1]))
    assert lat.shape == (1, 8, 8, 3)


def test_batch_too_large_raises(engine):
    with pytest.raises(ValueError):
        engine.generate(np.zeros(9, dtype=np.int32))


def test_stats_accumulate(engine):
    s = engine.stats()
    assert s["requests"] >= 4 and s["images"] >= 7
    assert s.get("images_per_sec", 0) > 0
    assert s["captures"] == 0  # the CPU runs each op eagerly
    assert set(s["replays"]) == {"generate", "transfer", "invert"}


# -- the port's engine against the JAX engine -----------------------------------


def test_transfer_and_invert_match_jax_engine(jax_pair):
    jpipe, jeng, tpipe = jax_pair
    eng = InferenceEngine(tpipe, EngineConfig(**CONFIG, ops=("transfer", "invert")))
    eng.warmup()
    imgs, src = _images(5, seed=1), np.array([0, 1, 1, 0, 1])
    np.testing.assert_allclose(eng.transfer(imgs, src), jeng.transfer(imgs, src),
                               rtol=0, atol=IMAGE_ATOL)
    want = jeng.invert(imgs, src)
    np.testing.assert_allclose(eng.invert(imgs, src), want, rtol=0,
                               atol=REL_TOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("guidance", [0.0, 3.0])
def test_generate_matches_jax_pipeline_from_the_same_noise(jax_pair, guidance):
    jpipe, _, tpipe = jax_pair
    eng = InferenceEngine(tpipe, EngineConfig(**CONFIG, guidance_factor=guidance,
                                              ops=("generate",)))
    eng.warmup()
    labels = np.array([1, 0, 1])
    noise = eng.start_noise(7)[:3].numpy()
    want = jpipe.generate(jnp.asarray(labels), jax.random.key(0), num_inference_steps=4,
                          guidance_factor=guidance, start_image=jnp.asarray(noise))
    want = np.asarray(jnp.clip(want / 2.0 + 0.5, 0.0, 1.0))
    np.testing.assert_allclose(eng.generate(labels, seed=7), want, rtol=0, atol=IMAGE_ATOL)


def test_start_noise_is_the_pipelines_own_draw(engine):
    """At max_batch the engine's start noise is what the pipeline's own
    ``generate`` draws from the same seed, so a full request equals it."""
    labels = np.array([0, 1] * 4)
    want = engine.pipe.generate(torch.as_tensor(labels), torch.Generator().manual_seed(5),
                                num_inference_steps=4)
    got = engine.generate(labels, seed=5)
    np.testing.assert_array_equal(got, ((want / 2 + 0.5).clamp(0, 1)).numpy())


def test_swap_params_equals_a_fresh_engine_and_checks_the_fingerprint():
    eng = InferenceEngine(_port_pipe(seed=0), EngineConfig(**CONFIG, ops=("transfer",)))
    eng.warmup()
    imgs, src = _images(3, seed=2), np.array([0, 1, 0])
    before = eng.transfer(imgs, src)
    other = _port_pipe(seed=1)
    wider = ConditionalDDIMPipeline.init_random(
        UNet2DConfig(**{**TINY, "block_out_channels": (8, 16)}), SchedulerConfig(**SCHED),
        device="cpu")
    with pytest.raises(ValueError, match="fingerprint"):
        eng.swap_params(wider)
    eng.swap_params(other)
    fresh = InferenceEngine(_port_pipe(seed=1), EngineConfig(**CONFIG, ops=("transfer",)))
    fresh.warmup()
    got = eng.transfer(imgs, src)
    np.testing.assert_array_equal(got, fresh.transfer(imgs, src))
    assert not np.array_equal(got, before)
    assert eng.stats()["swaps"] == 1 and eng.stats()["captures"] == 0


def test_params_tree_replace_params_and_fingerprint():
    pipe, other = _port_pipe(seed=0), _port_pipe(seed=1)
    assert pipe.arch_fingerprint() == other.arch_fingerprint()
    assert "lane_pack" not in pipe.arch_fingerprint()
    swapped = pipe.replace_params(other.params_tree)
    for k, v in swapped.params_tree.items():
        torch.testing.assert_close(v, other.params_tree[k], rtol=0, atol=0)
    # the tree shares storage with the module; replace_params leaves pipe as it was
    assert pipe.params_tree["conv_in.weight"].data_ptr() == pipe.model.conv_in.weight.data_ptr()
    assert not torch.equal(pipe.params_tree["conv_in.weight"], swapped.params_tree["conv_in.weight"])
    assert pipe.cast_params(torch.bfloat16).arch_fingerprint() == pipe.arch_fingerprint()


def test_op_not_warmed_up_and_bad_inputs_raise():
    eng = InferenceEngine(_port_pipe(), EngineConfig(**CONFIG, ops=("invert",)))
    with pytest.raises(RuntimeError, match="not warmed up"):
        eng.invert(_images(1), np.array([0]))
    eng.warmup()
    with pytest.raises(RuntimeError, match="not warmed up"):
        eng.transfer(_images(1), np.array([0]))
    with pytest.raises(ValueError, match="class labels"):
        eng.invert(_images(1), np.array([2]))
    with pytest.raises(ValueError, match="shape"):
        eng.invert(_images(1, shape=(16, 16, 3)), np.array([0]))
    with pytest.raises(TypeError):
        InferenceEngine(object())


# -- the SD route ---------------------------------------------------------------

TINY_SD = dict(
    sample_size=4, block_out_channels=(16, 32),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1, cross_attention_dim=16, attention_head_dim=(2, 4), norm_num_groups=4,
)
TINY_VAE = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4,
                latent_channels=4, sample_size=32)
SD_SCHED = dict(num_train_timesteps=50, timestep_spacing="leading", clip_sample=False,
                set_alpha_to_one=False, steps_offset=1)
SD_CONFIG = dict(max_batch=4, num_inference_steps=2)


def test_sd_engine_transfer_matches_jax_engine(tmp_path):
    jpipe = JaxSDPipeline.init_random(JaxSDConfig(**TINY_SD), JaxVAEConfig(**TINY_VAE),
                                      JaxSchedulerConfig(**SD_SCHED), num_classes=2,
                                      class_embedding_dim=16, seed=0)
    jpipe.save_pretrained(str(tmp_path))
    tpipe = SDImg2ImgPipeline.from_pretrained(str(tmp_path), device="cpu")
    jeng = JaxEngine(jpipe, JaxEngineConfig(**SD_CONFIG, ops=("transfer",)))
    jeng.warmup()
    eng = InferenceEngine(tpipe, EngineConfig(**SD_CONFIG, ops=("transfer",)))
    eng.warmup()
    assert eng.image_shape == jeng.image_shape == (32, 32, 3)
    imgs, src = _images(3, seed=4, shape=(32, 32, 3)), np.array([0, 1, 1])
    got = eng.transfer(imgs, src)
    np.testing.assert_allclose(got, jeng.transfer(imgs, src), rtol=0, atol=SD_IMAGE_ATOL)
    assert tpipe.arch_fingerprint() != _port_pipe().arch_fingerprint()
    assert set(tpipe.params_tree) == {"unet", "vae", "class_embedding"}
