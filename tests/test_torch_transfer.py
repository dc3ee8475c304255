"""The port's guided transfer methods against the JAX package, on the CPU.

A tiny JAX ``ConditionalDDIMPipeline`` is saved by the JAX package and
loaded by the port, as in ``test_torch_pipeline.py``.  Images and
embeddings come from numpy; ``cfg_forward_start``'s forward noise is drawn
by the test from the same ``torch.Generator`` state the port draws from and
handed to the JAX sampler as an already-noised start image (torch cannot
reproduce ``jax.random``).  Both sides run float32 in a different order;
trajectories agree to 1e-4 of the output's largest magnitude (the first
generation row divides by sqrt(alpha_999), which lifts a random model's
outputs to ~1e2 and float32 rounding with them).
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
from phendiff_tpu.core import scheduler as jax_S  # noqa: E402
from phendiff_tpu.models import UNet2DConfig as JaxUNetConfig  # noqa: E402
from phendiff_tpu.pipelines import ConditionalDDIMPipeline as JaxPipeline  # noqa: E402
from phendiff_tpu.pipelines import conditional_ddim as jax_cd  # noqa: E402
from phendiff_tpu.pipelines import transfer as jax_transfer  # noqa: E402
from phendiff_tpu_torch.pipelines import transfer  # noqa: E402
from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline  # noqa: E402

torch.set_num_threads(1)

TINY = dict(
    sample_size=16, block_out_channels=(8, 16),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1, norm_num_groups=4, attention_head_dim=4, num_class_embeds=2,
)
SCHEDULERS = {  # the bench scheduler, and the same with x0 clipping in the guided loss
    "bench": JaxSchedulerConfig(num_train_timesteps=1000, timestep_spacing="trailing",
                                clip_sample=False),
    "clipped": JaxSchedulerConfig(num_train_timesteps=1000, timestep_spacing="trailing",
                                  clip_sample=True),
}
REL_TOL = 1e-4  # of the output's largest magnitude
STEPS = 3


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    out = {}
    base = JaxPipeline.init_random(JaxUNetConfig(**TINY), SCHEDULERS["bench"], seed=2)
    for name, sched in SCHEDULERS.items():
        pipe = dataclasses.replace(base, scheduler_config=sched, lane_pack=False)
        path = str(tmp_path_factory.mktemp(name))
        pipe.save_pretrained(path)
        out[name] = (pipe, ConditionalDDIMPipeline.from_pretrained(path, device="cpu"))
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
def test_cfg_forward_start_matches_jax(saved, sched_name):
    jpipe, tpipe = saved[sched_name]
    images, _, tgt = _inputs(1)
    got = transfer.cfg_forward_start(
        tpipe.denoiser_fn(), tpipe.schedule, torch.from_numpy(images),
        tpipe.class_embeddings(torch.from_numpy(tgt)), torch.Generator().manual_seed(7),
        num_inference_steps=2 * STEPS,
    )
    # the port's one draw, from the same generator state
    noise = torch.randn(images.shape, generator=torch.Generator().manual_seed(7)).numpy()
    ts, _ = jax_S.timestep_pairs(jpipe.scheduler_config, 2 * STEPS, 0.5)
    start = jax_S.add_noise(jpipe.schedule, jnp.asarray(images), jnp.asarray(noise),
                            jnp.asarray(ts[0]))
    want = jax_cd.ddim_sample(
        jpipe.denoiser_fn(), jpipe.schedule, jpipe.class_embeddings(jnp.asarray(tgt)),
        start_image=start, add_forward_noise=False, num_inference_steps=2 * STEPS,
        frac_diffusion_skipped=0.5, guidance=jax_cd.GuidanceConfig(2.5, "imagen"),
    )
    assert got.shape == images.shape and torch.isfinite(got).all()
    _assert_close_to_scale(got, want)


def test_guided_inverted_start_matches_jax(saved):
    """With the bench scheduler.  Under x0 clipping the output is bounded
    by 1 while the trajectory reaches ~1e2, so rounding differences no
    longer scale with the output: there the single step is compared
    (``test_guided_gradient_matches_jax_and_needs_no_frozen_model``)."""
    jpipe, tpipe = saved["bench"]
    images, src, tgt = _inputs()
    want = jax_transfer.guided_inverted_start(
        jpipe.denoiser_fn(), jpipe.schedule, jnp.asarray(images),
        jpipe.class_embeddings(jnp.asarray(src)), jpipe.class_embeddings(jnp.asarray(tgt)),
        guidance_loss_scale=1e-2, num_inference_steps=STEPS,
    )
    flags = [p.requires_grad for p in tpipe.model.parameters()]
    with tpipe.frozen():
        assert not any(p.requires_grad for p in tpipe.model.parameters())
        got = transfer.guided_inverted_start(
            tpipe.denoiser_fn(), tpipe.schedule, torch.from_numpy(images),
            tpipe.class_embeddings(torch.from_numpy(src)),
            tpipe.class_embeddings(torch.from_numpy(tgt)),
            guidance_loss_scale=1e-2, num_inference_steps=STEPS,
        )
    assert [p.requires_grad for p in tpipe.model.parameters()] == flags
    assert got.grad_fn is None and torch.isfinite(got).all()
    _assert_close_to_scale(got, want)


def test_guided_gradient_matches_jax_and_needs_no_frozen_model(saved):
    """One guided step's input gradient against ``jax.grad`` of the same
    loss; freezing the parameters changes nothing but the graph."""
    jpipe, tpipe = saved["clipped"]
    images, _, tgt = _inputs(2)
    target = images[::-1].copy()
    t = 500

    def loss(x):
        out = jpipe.denoiser_fn()(x, jnp.full((2,), t), jpipe.class_embeddings(jnp.asarray(tgt)))
        x0, _ = jax_S.predict_x0_eps(jpipe.schedule, out, t, x)
        x0 = jax_S._maybe_clip_x0(jpipe.schedule, x0)
        return jnp.sum(jax_transfer.lp_loss(x0, jnp.asarray(target)))

    want = jax.jit(jax.grad(loss))(jnp.asarray(images))
    args = (tpipe.denoiser_fn(), tpipe.schedule, torch.from_numpy(images), t,
            torch.from_numpy(target), tpipe.class_embeddings(torch.from_numpy(tgt)))
    out, grad = transfer.guided_gradient(*args)
    with tpipe.frozen():
        out_f, grad_f = transfer.guided_gradient(*args)
    assert torch.equal(out, out_f) and torch.equal(grad, grad_f)
    assert out.grad_fn is None and float(grad.abs().max()) > 0
    np.testing.assert_allclose(grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


def test_guided_gradient_batch_independent(saved):
    """Losses are summed, not averaged: sample 0's trajectory is the same
    alone and in a batch of two."""
    _, tpipe = saved["bench"]
    images, _, tgt = _inputs(3)
    den = tpipe.denoiser_fn()
    emb = tpipe.class_embeddings(torch.from_numpy(tgt))
    kw = dict(guidance_loss_scale=1e-2, num_inference_steps=STEPS)
    single = transfer.custom_guided_generation(den, tpipe.schedule,
                                               torch.from_numpy(images[:1]), emb[:1], **kw)
    batched = transfer.custom_guided_generation(den, tpipe.schedule,
                                                torch.from_numpy(images), emb, **kw)
    scale = max(1.0, float(batched.abs().max()))
    torch.testing.assert_close(single[0], batched[0], rtol=0, atol=1e-5 * scale)
    unguided = transfer.custom_guided_generation(
        den, tpipe.schedule, torch.from_numpy(images), emb,
        guidance_loss_scale=0.0, num_inference_steps=STEPS)
    assert not torch.allclose(batched, unguided)


def test_lp_loss_and_gaussianity_match_jax():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    b = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    for p in (1.0, 2.0, 3.0):
        np.testing.assert_allclose(
            transfer.lp_loss(torch.from_numpy(a), torch.from_numpy(b), p).numpy(),
            np.asarray(jax_transfer.lp_loss(jnp.asarray(a), jnp.asarray(b), p)), rtol=1e-6)
    assert transfer.lp_loss(torch.zeros(2, 3, 3, 1), torch.ones(2, 3, 3, 1)).tolist() == [3.0, 3.0]
    x = (rng.standard_normal((4, 8, 8, 3)) ** 3).astype(np.float32)
    got = transfer.check_gaussianity(torch.from_numpy(x))
    want = jax_transfer.check_gaussianity(jnp.asarray(x))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6)


def test_denoiser_records_a_graph_only_for_a_grad_input(saved):
    _, tpipe = saved["bench"]
    den = tpipe.denoiser_fn()
    x = torch.zeros(1, 16, 16, 3)
    t = torch.tensor([10])
    emb = tpipe.class_embeddings(torch.tensor([0]))
    assert den(x, t, emb).grad_fn is None
    assert den(x.requires_grad_(), t, emb).grad_fn is not None
    with torch.no_grad():
        assert den(x, t, emb).grad_fn is None
    assert transfer.TRANSFER_METHODS == jax_transfer.TRANSFER_METHODS
