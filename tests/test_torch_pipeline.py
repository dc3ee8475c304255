"""The DDIB slice end to end: a tiny JAX ``ConditionalDDIMPipeline`` is saved,
the port loads the folder, and the port's ``ddib`` matches the JAX ``ddib``;
plus the port's samplers, folder I/O and safetensors codec.

Images, embeddings and noise come from numpy and go to both sides.  The
two run the same float32 arithmetic in a different order.  Tolerances are
relative to the output's scale: the first generation row of the bench
scheduler divides by sqrt(alpha_999) ~ 0.0064, so a random-init model's
sampler outputs reach ~1e2 and float32 rounding differences grow with
them: the outputs agree to 1e-4 of their largest magnitude.
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
from phendiff_tpu.pipelines import ConditionalDDIMPipeline as JaxPipeline  # noqa: E402
from phendiff_tpu.pipelines import conditional_ddim as jax_cd  # noqa: E402
from phendiff_tpu.pipelines import transfer as jax_transfer  # noqa: E402
from phendiff_tpu_torch.core.scheduler import SchedulerConfig  # noqa: E402
from phendiff_tpu_torch.models.config import UNet2DConfig  # noqa: E402
from phendiff_tpu_torch.pipelines import conditional_ddim as cd  # noqa: E402
from phendiff_tpu_torch.pipelines import io  # noqa: E402
from phendiff_tpu_torch.pipelines import transfer  # noqa: E402
from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline  # noqa: E402

torch.set_num_threads(1)

TINY = dict(
    sample_size=16, block_out_channels=(8, 16),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1, norm_num_groups=4, attention_head_dim=4, num_class_embeds=2,
)
BENCH_SCHED = dict(num_train_timesteps=1000, timestep_spacing="trailing", clip_sample=False)
ZERO_SNR_JSON = os.path.join(os.path.dirname(__file__), "..", "configs", "noise_scheduler",
                             "ddim_1k_epsilon.json")
REL_TOL = 1e-4  # of the output's largest magnitude
SCHEDULERS = {
    "bench": JaxSchedulerConfig(**BENCH_SCHED),
    "ddim_1k_epsilon": JaxSchedulerConfig.from_json(ZERO_SNR_JSON),
}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """One tiny JAX pipeline per scheduler, saved by the JAX package."""
    out = {}
    for name, sched in SCHEDULERS.items():
        pipe = JaxPipeline.init_random(JaxUNetConfig(**TINY), sched, seed=2)
        pipe = dataclasses.replace(pipe, lane_pack=False)
        path = str(tmp_path_factory.mktemp(name))
        pipe.save_pretrained(path)
        out[name] = (pipe, path)
    return out


def _assert_close_to_scale(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=REL_TOL * scale)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    images = np.clip(rng.standard_normal((2, 16, 16, 3)) * 0.5, -1, 1).astype(np.float32)
    return images, np.array([0, 1]), np.array([1, 0])


@pytest.mark.parametrize("sched_name", sorted(SCHEDULERS))
def test_ddib_matches_jax_from_saved_folder(saved, sched_name):
    jpipe, path = saved[sched_name]
    tpipe = ConditionalDDIMPipeline.from_pretrained(path, device="cpu")
    assert tpipe.scheduler_config.to_json_dict() == jpipe.scheduler_config.to_json_dict()
    images, src, tgt = _inputs()
    want = jax_transfer.ddib(
        jpipe.denoiser_fn(), jpipe.schedule, jnp.asarray(images),
        jpipe.class_embeddings(jnp.asarray(src)), jpipe.class_embeddings(jnp.asarray(tgt)),
        num_inference_steps=3,
    )
    got = transfer.ddib(
        tpipe.denoiser_fn(), tpipe.schedule, torch.from_numpy(images),
        tpipe.class_embeddings(torch.from_numpy(src)),
        tpipe.class_embeddings(torch.from_numpy(tgt)), num_inference_steps=3,
    )
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    _assert_close_to_scale(got, want)


def test_samplers_match_jax(saved):
    jpipe, path = saved["bench"]
    tpipe = ConditionalDDIMPipeline.from_pretrained(path, device="cpu")
    images, src, _ = _inputs(1)
    jemb = jpipe.class_embeddings(jnp.asarray(src))
    temb = tpipe.class_embeddings(torch.from_numpy(src))
    want = jax_cd.ddim_invert(jpipe.denoiser_fn(), jpipe.schedule, jnp.asarray(images), jemb,
                              num_inference_steps=3)
    got = tpipe.invert(torch.from_numpy(images), torch.from_numpy(src), num_inference_steps=3)
    _assert_close_to_scale(got, want)
    # batched cond+uncond CFG (imagen, w=3) from a given start image
    for w in (3.0, np.array([0.5, 2.0], np.float32)):
        guidance_j = jax_cd.GuidanceConfig(w if isinstance(w, float) else jnp.asarray(w))
        guidance_t = cd.GuidanceConfig(w if isinstance(w, float) else torch.from_numpy(w))
        want = jax_cd.ddim_sample(jpipe.denoiser_fn(), jpipe.schedule, jemb,
                                  start_image=jnp.asarray(images), num_inference_steps=3,
                                  guidance=guidance_j)
        got = cd.ddim_sample(tpipe.denoiser_fn(), tpipe.schedule, temb,
                             start_image=torch.from_numpy(images), num_inference_steps=3,
                             guidance=guidance_t)
        _assert_close_to_scale(got, want)


def test_generate_with_generators_and_eta():
    tpipe = ConditionalDDIMPipeline.init_random(
        UNet2DConfig(**TINY), SchedulerConfig(num_train_timesteps=100), seed=0, device="cpu"
    )
    labels = torch.tensor([0, 1])
    a = tpipe.generate(labels, torch.Generator().manual_seed(5), num_inference_steps=3, eta=0.5)
    b = tpipe.generate(labels, torch.Generator().manual_seed(5), num_inference_steps=3, eta=0.5)
    c = tpipe.generate(labels, torch.Generator().manual_seed(6), num_inference_steps=3, eta=0.5)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, 16, 16, 3) and torch.isfinite(a).all()
    u = tpipe.generate(None, torch.Generator().manual_seed(5), num_inference_steps=2,
                       batch_size=3, frac_diffusion_skipped=0.5)
    assert u.shape == (3, 16, 16, 3)
    assert float(cd.to_images(u).min()) >= 0.0 and float(cd.to_images(u).max()) <= 1.0
    with pytest.raises(ValueError):
        cd.ddim_sample(tpipe.denoiser_fn(), tpipe.schedule, torch.zeros(2, 32),
                       shape=(2, 16, 16, 3))  # noise needs a generator


def test_save_pretrained_round_trips_through_both_packages(saved, tmp_path):
    jpipe, path = saved["bench"]
    tpipe = ConditionalDDIMPipeline.from_pretrained(path, device="cpu")
    out = str(tmp_path / "port_saved")
    tpipe.save_pretrained(out)
    back = JaxPipeline.from_pretrained(out)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jpipe.params))
    got = jax.tree.leaves(jax.tree.map(np.asarray, back.params))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    assert back.unet_config == jpipe.unet_config


def test_safetensors_codec_interoperates(tmp_path):
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(0)
    tensors = {"params/a/kernel": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
               "params/b": np.arange(5, dtype=np.int64), "c": np.zeros((0, 2), np.float32),
               "d": rng.standard_normal(7).astype(np.float16)}
    io.save_safetensors(tensors, str(tmp_path / "mine.safetensors"))
    save_file(tensors, str(tmp_path / "theirs.safetensors"))
    for loaded in (load_file(str(tmp_path / "mine.safetensors")),
                   io.load_safetensors(str(tmp_path / "theirs.safetensors"))):
        assert set(loaded) == set(tensors)
        for k, v in tensors.items():
            assert loaded[k].dtype == v.dtype
            np.testing.assert_array_equal(loaded[k], v)
    (tmp_path / "bad.safetensors").write_bytes(b"\xff" * 16)
    with pytest.raises(ValueError):
        io.load_safetensors(str(tmp_path / "bad.safetensors"))
