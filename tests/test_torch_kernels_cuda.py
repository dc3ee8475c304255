"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch and the port, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Every test carries the ``cuda`` marker and skips without a card.
Tolerances: in bf16 the attention kernel (tensor cores) rounds the
unnormalised p to bf16 where the plain version rounds the normalised p, so
outputs agree to about one bf16 ulp (rtol 2**-6, atol 2e-3); in f32 (CUDA
cores) they agree to f32 rounding of differently ordered sums and the exp2
approximation (rtol 1e-4, atol 1e-5).  The forward's base-2 row
log-sum-exp agrees with ``torch.logsumexp`` of the plain f32 scores over
ln 2 to f32 rounding of sums of up to 4096 terms (rtol 1e-5, atol 1e-4).  GroupNorm outputs
agree to one bf16 ulp (rtol 2**-7, atol 1e-3), or to f32 rounding of
differently ordered sums (1e-4) in f32.  The GroupNorm backward kernel is
held against ``group_norm_bwd_plain`` (the same closed form in plain f32)
by relative L2 error: dx to 5e-3 in bf16 (one bf16 rounding of each
element) and 1e-5 in f32, dscale and dbias to 1e-4 (f32 sums of up to 0.5 M
terms in another order).  Through autograd, kernel against the plain path,
bf16 dx agrees to one bf16 ulp (each side rounds its own f32 dx) and to
rel L2 1e-4.  The forward's [B, G] mean and rstd agree with the plain
statistics to f32 rounding of differently ordered sums (rtol, atol 1e-5).

The attention backward is held against ``flash_attention_bwd_plain`` by
relative L2 error per gradient: in bf16 the kernel takes the row term from
the bf16 forward output and rounds ds and p at slightly different values
than the plain version, so single bf16 roundings of ds flip (5e-3); in f32 the two differ at f32
rounding and the exp2 approximation (1e-5; 7e-7 measured).  Gradients of a
whole UNet in f32 through the kernels match the plain path to rel L2 1e-3
per tensor (f32 rounding through a few dozen layers).  Channel moments are f32 sums
of up to 8192 terms in another order (rtol 1e-4, atol 1e-2).
"""

import math

import pytest
import torch

from phendiff_tpu_torch.ops import attention as attention_mod
from phendiff_tpu_torch.ops import group_norm as group_norm_mod
from phendiff_tpu_torch.ops.flash_attention import (
    attention_plain,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
)
from phendiff_tpu_torch.ops.gn_kernels import (
    _launch as gn_launch,
    channel_moments,
    channel_moments_plain,
    fused_group_norm,
    fused_group_norm_bwd,
    group_norm_bwd_plain,
    group_norm_plain,
    group_stats_plain,
)

ATTN_TOL = {torch.bfloat16: dict(rtol=2.0**-6, atol=2e-3),
            torch.float32: dict(rtol=1e-4, atol=1e-5)}
GN_TOL = {torch.bfloat16: dict(rtol=2.0**-7, atol=1e-3),
          torch.float32: dict(rtol=1e-4, atol=1e-4)}
GN_STATS_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_REL_L2 = {torch.bfloat16: 5e-3, torch.float32: 1e-5}
UNET_GRAD_REL_L2 = 1e-3
LSE_TOL = dict(rtol=1e-5, atol=1e-4)


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


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


def _qkv_slices(cuda, b, s, h, d, dtype, seed):
    """q, k, v as the UNet hands them over (column slices of one fused qkv),
    its leaf, and an output gradient."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=cuda).to(dtype).requires_grad_()
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    gout = torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype)
    return qkv, (q, k, v), gout


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", [(4, 1024, 32, 8), (1, 2048, 4, 64)])
def test_flash_attention_bf16_kernels_are_deterministic(cuda, b, s, h, d):
    qkv, (q, k, v), gout = _qkv_slices(cuda, b, s, h, d, torch.bfloat16, 7)
    outs = [flash_attention(q, k, v) for _ in range(2)]
    grads = [torch.autograd.grad(o, qkv, gout)[0] for o in outs]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])  # fixed order, no atomics
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [17, 300, 1000])
def test_flash_attention_ragged_s_and_padded_head_dim(cuda, s, dtype):
    # S not a multiple of any tile; D = 4 is zero-padded up to 8
    qkv, (q, k, v), gout = _qkv_slices(cuda, 2, s, 3, 4, dtype, s)
    out = flash_attention(q, k, v)
    (dqkv,) = torch.autograd.grad(out, qkv, gout)
    torch.cuda.synchronize()
    qd, kd, vd = (t.detach() for t in (q, k, v))
    torch.testing.assert_close(out.float(), attention_plain(qd, kd, vd).float(), **ATTN_TOL[dtype])
    for got, want in zip(dqkv.split(3 * 4, dim=-1), flash_attention_bwd_plain(qd, kd, vd, gout)):
        assert torch.isfinite(got).all()
        assert _rel_l2(got.unflatten(-1, (3, 4)), want) < BWD_REL_L2[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h,d", [(1024, 8, 8), (300, 2, 64)])
def test_flash_attention_lse_is_base2_logsumexp(cuda, s, h, d, dtype):
    from phendiff_tpu_torch.ops.flash_attention import _launch

    _, (q, k, v), _ = _qkv_slices(cuda, 2, s, h, d, dtype, 3)
    q, k, v = (t.detach() for t in (q, k, v))
    scale = d**-0.5
    _, lse = _launch(q, k, v, scale, with_lse=True)
    torch.cuda.synchronize()
    scores = torch.einsum("bqhd,bkhd->bhqk", (q * torch.tensor(scale, dtype=dtype)).float(),
                          k.float())
    assert lse.shape == (2, h, s) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1) / math.log(2), **LSE_TOL)


# S of the main path's three levels with group widths 2, 6, 12 and 16, and
# a ragged S
GN_SHAPES = [(16384, 64, 32), (4096, 192, 32), (1024, 512, 32), (100, 48, 8),
             (16384, 192, 32), (4096, 384, 32), (1024, 64, 32), (1024, 384, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,c,groups", GN_SHAPES)
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_kernel_matches_plain(cuda, s, c, groups, act):
    g = torch.Generator(device=cuda).manual_seed(c)
    x32 = torch.randn(2, s, c, generator=g, device=cuda) * 2 + 0.5
    scale = torch.randn(c, generator=g, device=cuda)
    bias = torch.randn(c, generator=g, device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        x = x32.to(dtype)
        kw = dict(num_groups=groups, eps=1e-5, act=act, out_dtype=dtype)
        before = fused_group_norm.launches
        out = fused_group_norm(x, scale, bias, **kw)
        again = fused_group_norm(x, scale, bias, **kw)
        torch.cuda.synchronize()
        assert fused_group_norm.launches == before + 2  # one launch a call
        ref = group_norm_plain(x, scale, bias, **kw)
        assert torch.equal(out, again)  # deterministic statistics
        torch.testing.assert_close(out.float(), ref.float(), **GN_TOL[dtype])
        # the [B, G] mean and rstd the backward reads
        stats = gn_launch(x, scale, bias, groups, 1e-5, act, dtype)[1:]
        for got, want in zip(stats, group_stats_plain(x, groups, 1e-5)):
            torch.testing.assert_close(got, want, **GN_STATS_TOL)
    with pytest.raises(TypeError):  # the kernel writes the input's dtype
        fused_group_norm(x32, scale, bias, num_groups=groups, eps=1e-5,
                         out_dtype=torch.bfloat16)


GN_BWD_DX_REL_L2 = {torch.bfloat16: 5e-3, torch.float32: 1e-5}
GN_BWD_PARAM_REL_L2 = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("s,c,groups", GN_SHAPES)
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_bwd_kernel_matches_plain(cuda, s, c, groups, act):
    g = torch.Generator(device=cuda).manual_seed(c + 1)
    x32 = torch.randn(2, s, c, generator=g, device=cuda) * 2 + 0.5
    g32 = torch.randn(2, s, c, generator=g, device=cuda)
    scale = torch.randn(c, generator=g, device=cuda)
    bias = torch.randn(c, generator=g, device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        x, gout = x32.to(dtype), g32.to(dtype)
        mean, rstd = group_stats_plain(x, groups, 1e-5)  # nothing a kernel computed
        kw = dict(num_groups=groups, act=act)
        before = fused_group_norm_bwd.launches
        got = fused_group_norm_bwd(x, gout, scale, bias, mean, rstd, **kw)
        again = fused_group_norm_bwd(x, gout, scale, bias, mean, rstd, **kw)
        torch.cuda.synchronize()
        assert fused_group_norm_bwd.launches == before + 2
        ref = group_norm_bwd_plain(x, gout, scale, bias, mean, rstd, **kw)
        assert [t.dtype for t in got] == [dtype, torch.float32, torch.float32]
        assert all(torch.equal(a, b) for a, b in zip(got, again))  # deterministic
        assert _rel_l2(got[0], ref[0]) <= GN_BWD_DX_REL_L2[dtype]
        for a, want in zip(got[1:], ref[1:]):
            assert _rel_l2(a, want) <= GN_BWD_PARAM_REL_L2


# (B, S, C, G) of the batched regimes: blocks that hold many samples of a
# small map (SD-2.1's inner levels at batch 64), the batch reduction across
# sample groups and across clusters, and a ragged batch.
GN_BWD_BATCH_SHAPES = [(64, 4, 1280, 32), (64, 16, 2560, 32), (64, 256, 960, 32),
                       (33, 4, 1280, 32), (33, 256, 320, 32), (33, 4096, 64, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c,groups", GN_BWD_BATCH_SHAPES)
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_bwd_kernel_matches_plain_across_the_batch(cuda, b, s, c, groups, act):
    from phendiff_tpu_torch.ops.gn_kernels import gn_plan, gn_route

    g = torch.Generator(device=cuda).manual_seed(b + s + c)
    x32 = torch.randn(b, s, c, generator=g, device=cuda) * 2 + 0.5
    g32 = torch.randn(b, s, c, generator=g, device=cuda)
    scale = torch.randn(c, generator=g, device=cuda)
    bias = torch.randn(c, generator=g, device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        isz = torch.finfo(dtype).bits // 8
        assert gn_route(s, c, groups, isz, backward=True) == "cluster"
        if dtype == torch.bfloat16 and s <= 16:  # blocks of several whole samples
            assert gn_plan(s, c, groups, isz, True, b).nb > 1
        x, gout = x32.to(dtype), g32.to(dtype)
        mean, rstd = group_stats_plain(x, groups, 1e-5)
        kw = dict(num_groups=groups, act=act)
        before = fused_group_norm_bwd.launches
        got = fused_group_norm_bwd(x, gout, scale, bias, mean, rstd, **kw)
        again = fused_group_norm_bwd(x, gout, scale, bias, mean, rstd, **kw)
        torch.cuda.synchronize()
        assert fused_group_norm_bwd.launches == before + 2  # one launch a call
        ref = group_norm_bwd_plain(x, gout, scale, bias, mean, rstd, **kw)
        assert all(torch.equal(a, b2) for a, b2 in zip(got, again))  # deterministic
        assert _rel_l2(got[0], ref[0]) <= GN_BWD_DX_REL_L2[dtype]
        for a, want in zip(got[1:], ref[1:]):
            assert _rel_l2(a, want) <= GN_BWD_PARAM_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_stream_bwd_at_the_f32_sd_map(cuda, act):
    """The f32 SD UNet map that no cluster holds ([1, 4096, 960]) takes the
    streaming backward on its own: one count a call, bit-equal calls, the
    plain version's values."""
    from phendiff_tpu_torch.ops.gn_kernels import gn_route

    assert gn_route(4096, 960, 32, 4, backward=True) == "stream"
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(1, 4096, 960, generator=g, device=cuda) * 2 + 0.5
    gout = torch.randn(1, 4096, 960, generator=g, device=cuda)
    scale = torch.randn(960, generator=g, device=cuda)
    bias = torch.randn(960, generator=g, device=cuda)
    mean, rstd = group_stats_plain(x, 32, 1e-6)
    kw = dict(num_groups=32, act=act)
    before = (fused_group_norm_bwd.launches, fused_group_norm_bwd.stream_launches)
    got = fused_group_norm_bwd(x, gout, scale, bias, mean, rstd, **kw)
    again = fused_group_norm_bwd(x, gout, scale, bias, mean, rstd, **kw)
    torch.cuda.synchronize()
    assert (fused_group_norm_bwd.launches, fused_group_norm_bwd.stream_launches) == (
        before[0], before[1] + 2)
    ref = group_norm_bwd_plain(x, gout, scale, bias, mean, rstd, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _rel_l2(got[0], ref[0]) <= GN_BWD_DX_REL_L2[torch.float32]
    for a, want in zip(got[1:], ref[1:]):
        assert _rel_l2(a, want) <= GN_BWD_PARAM_REL_L2


# (S, C, G, streamed by gn_route itself): the SD VAE's 512 px maps stream
# on their own; smaller maps are sent down the streaming variant by hand.
GN_STREAM_SHAPES = [(262144, 128, 32, True), (4096, 960, 32, False), (300, 2560, 32, False),
                    (100, 48, 8, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,c,groups,natural", GN_STREAM_SHAPES)
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_stream_variant_matches_plain(cuda, monkeypatch, s, c, groups, natural,
                                                 act):
    from phendiff_tpu_torch.ops import gn_kernels

    if natural:
        assert gn_kernels.gn_route(s, c, groups, 2) == "stream"
    else:
        monkeypatch.setattr(gn_kernels, "gn_route", lambda *a, **k: "stream")
    g = torch.Generator(device=cuda).manual_seed(c + 2)
    x32 = torch.randn(2, s, c, generator=g, device=cuda) * 2 + 0.5
    g32 = torch.randn(2, s, c, generator=g, device=cuda)
    scale = torch.randn(c, generator=g, device=cuda)
    bias = torch.randn(c, generator=g, device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        x, gout = x32.to(dtype), g32.to(dtype)
        kw = dict(num_groups=groups, eps=1e-6, act=act, out_dtype=dtype)
        before = (fused_group_norm.launches, fused_group_norm.stream_launches)
        out, mean, rstd = gn_launch(x, scale, bias, groups, 1e-6, act, dtype)
        again = fused_group_norm(x, scale, bias, **kw)
        torch.cuda.synchronize()
        assert (fused_group_norm.launches, fused_group_norm.stream_launches) == (
            before[0], before[1] + 2)
        assert torch.equal(out, again)  # fixed-order sums
        torch.testing.assert_close(out.float(), group_norm_plain(x, scale, bias, **kw).float(),
                                   **GN_TOL[dtype])
        for got, want in zip((mean, rstd), group_stats_plain(x, groups, 1e-6)):
            torch.testing.assert_close(got, want, **GN_STATS_TOL)
        mean, rstd = group_stats_plain(x, groups, 1e-6)
        bkw = dict(num_groups=groups, act=act)
        before = fused_group_norm_bwd.stream_launches
        got = fused_group_norm_bwd(x, gout, scale, bias, mean, rstd, **bkw)
        again = fused_group_norm_bwd(x, gout, scale, bias, mean, rstd, **bkw)
        torch.cuda.synchronize()
        assert fused_group_norm_bwd.stream_launches == before + 2
        ref = group_norm_bwd_plain(x, gout, scale, bias, mean, rstd, **bkw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert _rel_l2(got[0], ref[0]) <= GN_BWD_DX_REL_L2[dtype]
        for a, want in zip(got[1:], ref[1:]):
            assert _rel_l2(a, want) <= GN_BWD_PARAM_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sd_unet_on_the_card_routes_self_and_cross_attention(cuda, monkeypatch, dtype):
    from phendiff_tpu_torch.core.precision import cast_matmul_weights
    from phendiff_tpu_torch.models.sd_unet import SDUNet, SDUNetConfig
    from phendiff_tpu_torch.obs.forward_profile import plain_kernels

    # f32 convolutions and products in full f32: with TF32 the two paths'
    # last-bit differences flip TF32 roundings
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)

    cfg = SDUNetConfig(block_out_channels=(128, 128), layers_per_block=1,
                       down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                       up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                       attention_head_dim=2, cross_attention_dim=64)  # heads of 64
    model = SDUNet(cfg, dtype=dtype).init_weights(torch.Generator().manual_seed(0)).to(cuda)
    if dtype == torch.bfloat16:
        model = cast_matmul_weights(model)
    x = torch.randn(2, 16, 16, 4, device=cuda)
    ctx = torch.randn(2, 77, 64, device=cuda)
    t = torch.tensor([10, 900], device=cuda)
    attn0, xla0 = flash_attention.launches, attention_mod.multi_head_attention.xla_route_calls
    with torch.no_grad():
        out = model(x, t, ctx)
        torch.cuda.synchronize()
        # 1 + 2 + 1 Transformer2D blocks (down, mid, up x 2): self by the kernel,
        # cross by the counted plain route
        assert flash_attention.launches - attn0 == 4
        assert attention_mod.multi_head_attention.xla_route_calls - xla0 == 4
        with plain_kernels():
            ref = model(x, t, ctx)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert _rel_l2(out, ref) <= (2e-2 if dtype == torch.bfloat16 else 1e-4)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,d", [(4, 1024, 32, 8), (2, 300, 4, 8), (1, 2048, 4, 64)])
def test_flash_attention_bwd_kernel_matches_plain(cuda, b, s, h, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(s + d)
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=cuda).to(dtype).requires_grad_()
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1))
    gout = torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype)
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(q, k, v)
    assert out.grad_fn is not None
    (dqkv,) = torch.autograd.grad(out, qkv, gout)
    torch.cuda.synchronize()
    assert (flash_attention.launches - f0, flash_attention_bwd.launches - b0) == (1, 1)
    ref = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), gout)
    for got, want in zip(dqkv.split(h * d, dim=-1), ref):
        assert got.dtype == dtype and torch.isfinite(got).all()
        assert _rel_l2(got.unflatten(-1, (h, d)), want) < BWD_REL_L2[dtype]
    with torch.no_grad():  # no gradient needed: no row log-sum-exp, no backward
        assert flash_attention(q, k, v).grad_fn is None


GN_AUTOGRAD_DX_REL_L2 = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_autograd_on_card_matches_plain(cuda, dtype):
    """Kernels against autograd through ``group_norm_plain``.  In bf16 each
    side rounds its own f32 dx, so an element may sit one bf16 ulp apart
    (``GN_TOL``), and few do: dx's relative L2 error is held to 1e-4.  One
    such flip of a typical element alone gives about 2e-5 here, so the
    bound allows a few dozen of the 32768; a rounding that leans one way
    gives about 2e-3.  Reading on an NVIDIA H100 80GB HBM3: 2.4e-6 in bf16,
    1.2e-7 in f32 (printed; ``pytest -rP`` shows it)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = (torch.randn(2, 256, 64, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    scale = torch.randn(64, generator=g, device=cuda)
    bias = torch.randn(64, generator=g, device=cuda)
    gout = torch.randn(2, 256, 64, generator=g, device=cuda).to(dtype)
    kw = dict(num_groups=8, eps=1e-5, act="silu", out_dtype=dtype)
    grads = []
    b0 = fused_group_norm_bwd.launches
    for fn in (fused_group_norm, group_norm_plain):
        xs, ss, bs = (t.clone().requires_grad_() for t in (x, scale, bias))
        out = fn(xs, ss, bs, **kw)
        assert out.grad_fn is not None
        grads.append(torch.autograd.grad(out, (xs, ss, bs), gout))
    assert fused_group_norm_bwd.launches == b0 + 1
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        tol = GN_TOL[dtype] if got.dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got.float(), want.float(), **tol)
    dx_rel_l2 = _rel_l2(grads[0][0], grads[1][0])
    print(f"dx rel L2 {dx_rel_l2:.3g}")
    assert dx_rel_l2 <= GN_AUTOGRAD_DX_REL_L2


@pytest.mark.cuda
def test_unet_gradients_on_card_match_plain_path(cuda, monkeypatch):
    from phendiff_tpu_torch.models.config import UNet2DConfig
    from phendiff_tpu_torch.models.unet2d import CondUNet2D

    cfg = UNet2DConfig(sample_size=32, block_out_channels=(32, 64), layers_per_block=1,
                       down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                       up_block_types=("AttnUpBlock2D", "UpBlock2D"), norm_num_groups=8,
                       attention_head_dim=8)
    model = CondUNet2D(cfg).init_weights(torch.Generator().manual_seed(0)).to(cuda)
    x = torch.randn(2, 32, 32, 3, device=cuda)
    t = torch.tensor([10, 900], device=cuda)
    labels = torch.tensor([0, 1], device=cuda)

    def grads():
        model.zero_grad(set_to_none=True)
        model(x, t, class_labels=labels).square().mean().backward()
        return {n: p.grad.clone() for n, p in model.named_parameters() if p.requires_grad}

    b0, gb0 = flash_attention_bwd.launches, fused_group_norm_bwd.launches
    got = grads()
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches - b0 == 4
    assert fused_group_norm_bwd.launches - gb0 == 21
    monkeypatch.setattr(group_norm_mod, "fused_group_norm",
                        lambda xx, s, b, **kw: group_norm_plain(xx, s, b, **kw))
    monkeypatch.setattr(attention_mod, "flash_attention",
                        lambda q, k, v, scale=None: attention_plain(q, k, v, scale=scale))
    want = grads()
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert torch.isfinite(got[name]).all() and got[name].abs().max() > 0, name
        assert _rel_l2(got[name], w) < UNET_GRAD_REL_L2, name


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((2, 8192, 128), torch.bfloat16),
                                         ((3, 100, 48), torch.float32)])
def test_channel_moments_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(shape, generator=g, device=cuda) + 0.25).to(dtype)
    before = channel_moments.launches
    got = channel_moments(x)
    again = channel_moments(x)
    torch.cuda.synchronize()
    assert channel_moments.launches == before + 2
    for a, b, ref in zip(got, again, channel_moments_plain(x)):
        assert a.shape == (shape[0], shape[2]) and a.dtype == torch.float32
        assert torch.equal(a, b)  # fixed-order combine: deterministic
        torch.testing.assert_close(a, ref, rtol=1e-4, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_kernel_launches_on_its_tensors_card(cuda, dtype):
    """With the current device set to card 0, each kernel called on card 1's
    tensors runs there (``on_tensor_device``): its outputs live on card 1,
    agree with the plain versions, and card 0 stays the current device."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(2, 256, 4, 8, generator=g, device=dev).to(dtype).requires_grad_()
               for _ in range(3))
    out = flash_attention(q, k, v)
    dq, dk, dv = torch.autograd.grad(out.float().square().sum(), (q, k, v))
    q32, k32, v32 = (t.detach().float().requires_grad_() for t in (q, k, v))
    ref = attention_plain(q32, k32, v32, scale=8 ** -0.5)
    rq, rk, rv = torch.autograd.grad(ref.square().sum(), (q32, k32, v32))
    x = torch.randn(2, 256, 64, generator=g, device=dev).to(dtype).requires_grad_()
    scale = torch.ones(64, device=dev, requires_grad=True)
    bias = torch.zeros(64, device=dev, requires_grad=True)
    y = fused_group_norm(x, scale, bias, num_groups=8, eps=1e-5, act="silu", out_dtype=dtype)
    dx, = torch.autograd.grad(y.float().sum(), (x,))
    x32 = x.detach().float().requires_grad_()
    y_ref = group_norm_plain(x32, scale.detach(), bias.detach(), num_groups=8, eps=1e-5,
                             act="silu")
    dx_ref, = torch.autograd.grad(y_ref.sum(), (x32,))
    moments = channel_moments(x.detach())
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
    for t in (out, dq, dk, dv, y, dx, *moments):
        assert t.device == dev
    assert _rel_l2(out, ref) < 1e-2 and _rel_l2(y, y_ref) < 1e-2
    for a, b in ((dq, rq), (dk, rk), (dv, rv), (dx, dx_ref)):
        assert _rel_l2(a, b) < 2e-2
    for a, b in zip(moments, channel_moments_plain(x.detach())):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-2)
