"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch and the port, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Every test carries the ``cuda`` marker and skips without a card.
Tolerances: in bf16 the attention kernel keeps p in f32 where the plain
version rounds it to bf16, so outputs agree to about one bf16 ulp (rtol
2**-6, atol 2e-3); in f32 they agree to f32 rounding of differently ordered
sums and the exp2 approximation (rtol 1e-4, atol 1e-5).  GroupNorm outputs
agree to one bf16 ulp (rtol 2**-7, atol 1e-3), or to f32 rounding of
differently ordered sums (1e-4) in f32.
"""

import pytest
import torch

from phendiff_tpu_torch.ops.flash_attention import attention_plain, flash_attention
from phendiff_tpu_torch.ops.gn_kernels import fused_group_norm, group_norm_plain

ATTN_TOL = {torch.bfloat16: dict(rtol=2.0**-6, atol=2e-3),
            torch.float32: dict(rtol=1e-4, atol=1e-5)}
GN_TOL = {torch.bfloat16: dict(rtol=2.0**-7, atol=1e-3),
          torch.float32: dict(rtol=1e-4, atol=1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h,d", [(1024, 32, 8), (300, 4, 8), (4096, 2, 64)])
def test_flash_attention_kernel_matches_plain(cuda, s, h, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(2, s, 3 * h * d, generator=g, device=cuda).to(dtype)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype
    ref = attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), **ATTN_TOL[dtype])
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())


@pytest.mark.cuda
@pytest.mark.parametrize("s,c,groups", [(16384, 64, 32), (4096, 192, 32), (1024, 512, 32),
                                        (100, 48, 8)])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_kernel_matches_plain(cuda, s, c, groups, act):
    g = torch.Generator(device=cuda).manual_seed(c)
    x32 = torch.randn(2, s, c, generator=g, device=cuda) * 2 + 0.5
    scale = torch.randn(c, generator=g, device=cuda)
    bias = torch.randn(c, generator=g, device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        x = x32.to(dtype)
        kw = dict(num_groups=groups, eps=1e-5, act=act, out_dtype=dtype)
        out = fused_group_norm(x, scale, bias, **kw)
        again = fused_group_norm(x, scale, bias, **kw)
        torch.cuda.synchronize()
        ref = group_norm_plain(x, scale, bias, **kw)
        assert torch.equal(out, again)  # deterministic statistics
        torch.testing.assert_close(out.float(), ref.float(), **GN_TOL[dtype])
    with pytest.raises(TypeError):  # the kernel writes the input's dtype
        fused_group_norm(x32, scale, bias, num_groups=groups, eps=1e-5,
                         out_dtype=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unet_on_the_card_runs_through_both_kernels(cuda, dtype):
    from phendiff_tpu_torch.core.precision import cast_matmul_weights
    from phendiff_tpu_torch.models.config import UNet2DConfig
    from phendiff_tpu_torch.models.unet2d import CondUNet2D

    cfg = UNet2DConfig(sample_size=32, block_out_channels=(32, 64), layers_per_block=1,
                       down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                       up_block_types=("AttnUpBlock2D", "UpBlock2D"), norm_num_groups=8)
    model = CondUNet2D(cfg, dtype=dtype).init_weights(torch.Generator().manual_seed(0))
    model = model.to(cuda)
    if dtype == torch.bfloat16:
        model = cast_matmul_weights(model)
    x = torch.randn(2, 32, 32, 3, device=cuda)
    gn0, attn0 = fused_group_norm.launches, flash_attention.launches
    with torch.no_grad():
        out = model(x, torch.tensor([10, 900], device=cuda), class_labels=torch.tensor([0, 1],
                                                                                        device=cuda))
    torch.cuda.synchronize()
    # 8 ResnetBlocks x 2 + 4 attention blocks + norm_out; 4 attention blocks
    assert fused_group_norm.launches - gn0 == 21
    assert flash_attention.launches - attn0 == 4
    assert out.dtype == torch.float32 and out.shape == x.shape and torch.isfinite(out).all()
