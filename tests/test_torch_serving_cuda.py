"""The serving engine's CUDA graphs on the card.

Imports only torch and the port, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_serving_cuda.py --noconftest -q

Every test carries the ``cuda`` marker and skips without a card.  A small
conditional DDIM with an attention level (every op through the attention
and GroupNorm kernels), bf16 weights and compute.  A replay runs the same
kernels on the same inputs as the eager op, and the kernels are
deterministic, so replays are held bit-equal to eager runs: after a capture,
after other work has allocated and freed memory on the card, with a
partial request's padding, and after ``swap_params``.
"""

import numpy as np
import pytest
import torch

from phendiff_tpu_torch.core.scheduler import SchedulerConfig
from phendiff_tpu_torch.models.config import UNet2DConfig
from phendiff_tpu_torch.tools.kernel_calls import unet_calls
from phendiff_tpu_torch.pipelines import transfer as T
from phendiff_tpu_torch.pipelines.conditional_ddim import to_images
from phendiff_tpu_torch.pipelines.ddim_pipeline import ConditionalDDIMPipeline
from phendiff_tpu_torch.serving import EngineConfig, InferenceEngine

SMALL = UNet2DConfig(
    sample_size=32, block_out_channels=(32, 64),
    down_block_types=("DownBlock2D", "AttnDownBlock2D"),
    up_block_types=("AttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1, norm_num_groups=8, attention_head_dim=8, num_class_embeds=2,
)
SCHED = SchedulerConfig(num_train_timesteps=1000, timestep_spacing="trailing", clip_sample=False)
CONFIG = EngineConfig(max_batch=8, num_inference_steps=10)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _pipe(seed):
    return ConditionalDDIMPipeline.init_random(
        SMALL, SCHED, seed=seed, dtype=torch.bfloat16, device="cuda").cast_params(torch.bfloat16)


def _eager_transfer(pipe, images01, src, tgt):
    x = torch.as_tensor(np.asarray(images01, np.float32) * 2.0 - 1.0, device="cuda")
    src, tgt = (torch.as_tensor(v, device="cuda") for v in (src, tgt))
    out = T.ddib(pipe.denoiser_fn(), pipe.schedule, x, pipe.class_embeddings(src),
                 pipe.class_embeddings(tgt), num_inference_steps=CONFIG.num_inference_steps)
    return to_images(out).cpu().numpy()


def _inputs(k, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((k, 32, 32, 3)).astype(np.float32), rng.integers(0, 2, k))


@pytest.mark.cuda
def test_every_op_is_one_graph_and_replays_equal_eager_runs(cuda):
    pipe = _pipe(0)
    eng = InferenceEngine(pipe, CONFIG)
    eng.warmup()
    s = eng.stats()
    assert s["captures"] == 3
    # 2 x 10 forwards (transfer) or 10 (generate, invert), each making the
    # calls the recorder finds in one forward of this model (4 attention, 21
    # GroupNorm, every one on a cluster plan)
    calls = unet_calls(SMALL, 32)
    per_forward = {"flash_attn_fwd": sum(calls["attention"].values()),
                   "group_norm_silu": sum(calls["group_norm"].values()),
                   "group_norm_silu_stream": 0, "flash_attn_fwd_wgmma": 0}
    assert per_forward["flash_attn_fwd"] == 4 and per_forward["group_norm_silu"] == 21
    for op, forwards in (("transfer", 20), ("generate", 10), ("invert", 10)):
        assert s["launches_per_replay"][op] == {k: forwards * n for k, n in per_forward.items()}

    images, src = _inputs(8)
    want = _eager_transfer(pipe, images, src, 1 - src)
    junk = torch.empty(1 << 28, dtype=torch.uint8, device=cuda)  # other work allocates ...
    del junk  # ... and frees memory on the card
    torch.cuda.empty_cache()
    np.testing.assert_array_equal(eng.transfer(images, src), want)

    labels = np.array([0, 1] * 4)
    g = torch.Generator(device=cuda).manual_seed(3)
    gen = pipe.generate(torch.as_tensor(labels, device=cuda), g, num_inference_steps=10)
    np.testing.assert_array_equal(eng.generate(labels, seed=3), to_images(gen).cpu().numpy())
    inv = pipe.invert(torch.as_tensor(images * 2.0 - 1.0, device=cuda),
                      torch.as_tensor(src, device=cuda), num_inference_steps=10)
    np.testing.assert_array_equal(eng.invert(images, src), inv.float().cpu().numpy())
    assert eng.stats()["replays"] == {"generate": 1, "transfer": 1, "invert": 1}


@pytest.mark.cuda
def test_partial_requests_are_padding_invariant(cuda):
    eng = InferenceEngine(_pipe(0), EngineConfig(max_batch=8, num_inference_steps=10,
                                                 ops=("transfer", "generate")))
    eng.warmup()
    images, src = _inputs(8, seed=1)
    full = eng.transfer(images, src)
    np.testing.assert_array_equal(eng.transfer(images[:5], src[:5]), full[:5])
    labels = np.array([1, 0, 0, 1, 1, 0, 1, 0])
    np.testing.assert_array_equal(eng.generate(labels[:3], seed=9),
                                  eng.generate(labels, seed=9)[:3])


@pytest.mark.cuda
def test_swap_params_needs_no_recapture(cuda):
    eng = InferenceEngine(_pipe(0), EngineConfig(max_batch=8, num_inference_steps=10,
                                                 ops=("transfer",)))
    eng.warmup()
    images, src = _inputs(8, seed=2)
    before = eng.transfer(images, src)
    other = _pipe(1)
    eng.swap_params(other)
    got = eng.transfer(images, src)
    np.testing.assert_array_equal(got, _eager_transfer(other, images, src, 1 - src))
    assert not np.array_equal(got, before)
    assert eng.stats()["captures"] == 1 and eng.stats()["swaps"] == 1
    # an f32 pipeline of the same architecture swaps in too: its weights
    # are rounded to the served bf16 storage, as cast_params rounds them
    f32 = ConditionalDDIMPipeline.init_random(SMALL, SCHED, seed=1, dtype=torch.bfloat16,
                                              device="cuda")
    eng.swap_params(f32)
    np.testing.assert_array_equal(eng.transfer(images, src), got)
