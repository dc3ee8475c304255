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
With an addend the forward kernel is bit-equal (output, mean and rstd) to
itself on the materialised sum, which PyTorch rounds the same way.

The attention backward is held against ``flash_attention_bwd_plain`` by
relative L2 error per gradient: in bf16 the kernel takes the row term from
the bf16 forward output and rounds ds and p at slightly different values
than the plain version, so single bf16 roundings of ds flip (5e-3); in f32 the two differ at f32
rounding and the exp2 approximation (1e-5; 7e-7 measured).  Gradients of a
whole UNet in f32 through the kernels match the plain path to rel L2 1e-3
per tensor (f32 rounding through a few dozen layers).  Channel moments are f32 sums
of up to 8192 terms in another order (rtol 1e-4, atol 1e-2).  The D = 72
forward (DiT-XL/2's heads) takes the attention tolerances above; a tiny
DiT on the card against its CPU forward agrees to rel L2 1e-4 in f32 and
3e-2 in bf16 (bf16 activations through two blocks, ~5e-3).  The fused DiT
boundary kernel forms x' as ``addcmul`` does (one rounding of f32
fma(gate, y, x)), so x' sits within one ulp of it; its z, rounded once,
is no farther from the f32 composition than the bf16 composition (two
roundings) is, and in f32 within rel L2 1e-6 of the float64 composition
(f32 rounding of ~10 operations an element, 7.5e-8 measured).  The
residual kernel sums in f32 in the plain version's order and rounds once,
so it is held bit-equal to it.
"""

import math

import pytest
import torch

from phendiff_tpu_torch.ops import adaln_norm as adaln_mod
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
FORWARD_REL_L2 = 2e-2  # a bf16 UNet forward through 41 GroupNorms and 6 attentions
LSE_TOL = dict(rtol=1e-5, atol=1e-4)


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


# D = 64 from WGMMA_MIN_S tokens takes the warpgroup kernels in bf16: SD-2.1's
# level 0 at 512 px (5 heads of 64, fused-qkv strides), and ragged S
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h,d", [(1024, 32, 8), (300, 4, 8), (4096, 2, 64), (4096, 5, 64),
                                   (300, 3, 64), (4097, 2, 64)])
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
@pytest.mark.parametrize("b,s,h,d", [(4, 1024, 32, 8), (1, 2048, 4, 64), (2, 4096, 5, 64),
                                     (2, 300, 3, 64), (2, 64, 20, 64)])
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
@pytest.mark.parametrize("s,h,d", [(1024, 8, 8), (300, 2, 64), (4097, 2, 64), (64, 20, 64),
                                   (16, 20, 64), (4, 20, 64)])
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


# The second GroupNorm of every ResnetBlock, which takes the time embedding
# as its addend: (B, S, C, G) of ddim_super_small_128 at batch 128 (clusters
# of 16, 4 and 1 blocks in bf16) and of sd21_128 at batch 256 (one block)
GN_ADDEND_SHAPES = [(128, 16384, 64, 32), (128, 4096, 128, 32), (128, 1024, 256, 32),
                    (256, 256, 320, 32), (256, 64, 640, 32), (256, 16, 1280, 32),
                    (256, 4, 1280, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,c,groups", GN_ADDEND_SHAPES)
def test_group_norm_addend_is_bit_equal_to_the_materialised_sum(cuda, b, s, c, groups, dtype):
    g = torch.Generator(device=cuda).manual_seed(s + c)
    x = (torch.randn(b, s, c, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    addend = torch.randn(b, c, generator=g, device=cuda).to(dtype)
    scale = torch.randn(c, generator=g, device=cuda)
    bias = torch.randn(c, generator=g, device=cuda)
    total = x + addend[:, None, :]
    for act in (None, "silu"):
        before = fused_group_norm.addend_launches
        got = gn_launch(x, scale, bias, groups, 1e-5, act, dtype, addend)
        want = gn_launch(total, scale, bias, groups, 1e-5, act, dtype)
        torch.cuda.synchronize()
        assert fused_group_norm.addend_launches == before + 1
        for u, w in zip(got, want):  # output, mean, rstd
            assert torch.equal(u, w)
        kw = dict(num_groups=groups, eps=1e-5, act=act, out_dtype=dtype)
        assert torch.equal(fused_group_norm(x, scale, bias, addend=addend, **kw), want[0])
    # recorded by autograd: the sum is formed first, the same bits
    before = fused_group_norm.addend_materialised
    out = fused_group_norm(x, scale.requires_grad_(), bias, addend=addend, **kw)
    assert fused_group_norm.addend_materialised == before + 1
    assert torch.equal(out.detach(), want[0])


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
    from phendiff_tpu_torch.ops.routes import plain_kernels

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
def test_unet_forward_with_the_addend_is_bit_equal_to_the_materialised_sum(cuda, monkeypatch):
    """The ddim_super_small_128 UNet: under no_grad its 17 ResnetBlocks hand
    the time embedding to the GroupNorm kernel, and the output has the bits
    of the forward that forms each sum first; under autograd all 17 form it."""
    from phendiff_tpu_torch.core.precision import cast_matmul_weights
    from phendiff_tpu_torch.models.config import super_small
    from phendiff_tpu_torch.models.unet2d import CondUNet2D

    model = CondUNet2D(super_small(), dtype=torch.bfloat16).init_weights(
        torch.Generator().manual_seed(0))
    model = cast_matmul_weights(model.to(cuda))
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(4, 128, 128, 3, generator=g, device=cuda)
    t = torch.tensor([10, 300, 600, 999], device=cuda)
    labels = torch.tensor([0, 1, 0, 1], device=cuda)

    def counts():
        return fused_group_norm.addend_launches, fused_group_norm.addend_materialised

    before = counts()
    with torch.no_grad():
        got = model(x, t, class_labels=labels)
    assert tuple(a - b for a, b in zip(counts(), before)) == (17, 0)
    with monkeypatch.context() as m:  # the sum formed before the call
        m.setattr(group_norm_mod, "fused_group_norm", lambda xx, s, b, addend=None, **kw: (
            fused_group_norm(xx if addend is None else xx + addend[:, None, :], s, b, **kw)))
        with torch.no_grad():
            want = model(x, t, class_labels=labels)
    assert torch.equal(got, want)
    before = counts()
    model(x, t, class_labels=labels).float().square().mean().backward()
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 17)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,d", [(4, 1024, 32, 8), (2, 300, 4, 8), (1, 2048, 4, 64),
                                     (2, 4096, 5, 64), (2, 300, 3, 64), (1, 4097, 2, 64),
                                     (2, 16, 20, 64), (2, 4, 20, 64)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h,d", [(4096, 5, 64), (1024, 10, 64), (256, 20, 64), (64, 20, 64),
                                   (16, 20, 64), (4, 20, 64), (1024, 32, 8)])
def test_flash_attention_takes_the_design_attention_design_names(cuda, s, h, d, dtype):
    """SD-2.1's self-attention shapes and the DDIM main path's: the forward
    and the backward launch the kernels of ``attention_design``'s design
    (wgmma for bf16 D = 64 from WGMMA_MIN_S tokens), once each a call."""
    from phendiff_tpu_torch.ops.flash_attention import WGMMA_MIN_S, attention_design

    qkv, (q, k, v), gout = _qkv_slices(cuda, 2, s, h, d, dtype, 11)
    want = attention_design(s, d, dtype)

    def counts():
        return [(fn.launches, fn.wgmma_launches) for fn in (flash_attention, flash_attention_bwd)]

    before = counts()
    out = flash_attention(q, k, v)
    torch.autograd.grad(out, qkv, gout)
    torch.cuda.synchronize()
    took = [(n - n0, w - w0) for (n, w), (n0, w0) in zip(counts(), before)]
    assert took == [(1, int(want == "wgmma"))] * 2
    assert (want == "wgmma") == (dtype == torch.bfloat16 and d == 64 and s >= WGMMA_MIN_S)


def _dit_qkv(cuda, b, s, h, dtype, seed):
    """q, k, v [B, S, H, 72] as DiT hands them over: views of one fused
    [B, S, 3, H, 72] qkv projection."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(b, s, 3, h, 72, generator=g, device=cuda).to(dtype)
    return qkv, (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,design", [(torch.bfloat16, "wgmma"), (torch.float32, "fma")])
@pytest.mark.parametrize("b,s,h", [(2, 1024, 16), (2, 300, 3), (1, 1000, 4), (2, 17, 2)])
def test_flash_attention_d72_forward_matches_plain(cuda, b, s, h, dtype, design):
    """DiT-XL/2's heads (D = 72) at its shape and at ragged S (one
    partial 128-key tile, S below one tile), each dtype's design forced and
    through ``flash_attention``'s route, once a call."""
    from phendiff_tpu_torch.ops import flash_attention as fa

    _, (q, k, v) = _dit_qkv(cuda, b, s, h, dtype, s + h)
    out = fa._launch(q, k, v, 72**-0.5, design=design)
    torch.cuda.synchronize()
    ref = attention_plain(q, k, v)
    assert out.shape == (b, s, h, 72) and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), **ATTN_TOL[dtype])
    before = (flash_attention.launches, flash_attention.wgmma_launches)
    routed = flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = fa.attention_design(s, 72, dtype)
    assert (flash_attention.launches - before[0], flash_attention.wgmma_launches - before[1]) \
        == (1, int(want == "wgmma"))
    assert want == design
    torch.testing.assert_close(routed.float(), ref.float(), **ATTN_TOL[dtype])


@pytest.mark.cuda
def test_flash_attention_d72_refuses_the_mma_sync_design(cuda):
    """D = 72 has no mma.sync kernel: the C entry refuses the design and
    launches nothing."""
    from phendiff_tpu_torch.ops import flash_attention as fa

    _, (q, k, v) = _dit_qkv(cuda, 1, 300, 2, torch.bfloat16, 3)
    with pytest.raises(RuntimeError):
        fa._launch(q, k, v, 72**-0.5, design="mma_sync")


@pytest.mark.cuda
def test_flash_attention_d72_reads_the_qkv_views_in_place(cuda):
    """No copy of q, k or v: the call allocates its output alone."""
    from phendiff_tpu_torch.ops import flash_attention as fa

    _, (q, k, v) = _dit_qkv(cuda, 4, 1024, 16, torch.bfloat16, 5)
    assert all(fa._aligned(t) for t in (q, k, v)) and not q.is_contiguous()
    flash_attention(q, k, v)  # the kernels built and loaded
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    out_bytes = out.numel() * out.element_size()
    slack = 1 << 20
    assert torch.cuda.max_memory_allocated(cuda) - before <= out_bytes + slack
    assert q.numel() * q.element_size() > slack  # a copy of q, k or v would show


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_d72_with_a_gradient_raises(cuda, dtype):
    qkv, (q, k, v) = _dit_qkv(cuda, 1, 256, 2, dtype, 9)
    qkv.requires_grad_()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    launches = flash_attention.launches
    with pytest.raises(ValueError, match="head dim 72"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="head dim 72"):
        attention_mod.multi_head_attention(q, k, v)
    assert flash_attention.launches == launches  # nothing launched, no other route taken
    with torch.no_grad():
        flash_attention(q, k, v)
    assert flash_attention.launches == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dit_on_the_card_takes_the_d72_kernel(cuda, dtype):
    """A DiT of DiT-XL/2's head dim: every self-attention call on the
    kernel (none on the plain route) and every sub-layer boundary one launch
    of the boundary kernel (none on the composition), against its own CPU
    forward."""
    from phendiff_tpu_torch.models.dit import DiT, DiTConfig

    cfg = DiTConfig(input_size=32, hidden_size=144, depth=2, num_heads=2, num_classes=10)
    torch.manual_seed(0)
    model = DiT(cfg).init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(2, 32, 32, 4)
    t, y = torch.tensor([10, 900]), torch.tensor([1, 10])
    with torch.no_grad():
        want = model(x, t, y)
        model.to(cuda)
        model.dtype = dtype
        xla, launches = attention_mod.multi_head_attention.xla_route_calls, \
            flash_attention.launches
        boundary = adaln_mod.adaln_norm.launches, adaln_mod.adaln_norm.plain_calls
        got = model(x.to(cuda), t.to(cuda), y.to(cuda))
    torch.cuda.synchronize()
    assert attention_mod.multi_head_attention.xla_route_calls == xla
    assert flash_attention.launches == launches + cfg.depth
    assert (adaln_mod.adaln_norm.launches, adaln_mod.adaln_norm.plain_calls) == (
        boundary[0] + 1 + 2 * cfg.depth, boundary[1])
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    assert _rel_l2(got.float().cpu(), want) < tol


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).long()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["full", "no_y", "no_write"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,c", [(32, 1024, 1152), (1, 17, 144), (2, 33, 384), (2, 33, 768),
                                   (2, 33, 1024)])
def test_adaln_norm_kernel_matches_the_composition(cuda, b, s, c, dtype, variant):
    """DiT-XL/2's boundary shape, a ragged one, and DiT-S/B/L's widths (one
    to five 8-channel vectors a lane: every width the kernel is built for),
    each variant, the [B, C]
    rows as the unbind views of a [B, 6, C] modulation (row stride 6C) read
    in place: one launch, x' within one ulp of ``addcmul``'s, z as close to
    the higher-precision composition as the module docstring says."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x, y = (torch.randn(b, s, c, generator=g, device=cuda).to(dtype) for _ in range(2))
    mod = (0.5 * torch.randn(b, 6, c, generator=g, device=cuda)).to(dtype)
    mod[:, 1::3] += 1
    _, _, gate, shift, scale1p, _ = mod.unbind(1)
    assert gate.stride(0) == shift.stride(0) == scale1p.stride(0) == 6 * c
    if variant == "no_y":
        gate = y = None
    keep = variant != "no_write"
    launches, plain = adaln_mod.adaln_norm.launches, adaln_mod.adaln_norm.plain_calls
    got_x, got_z = adaln_mod.adaln_norm(x, gate, y, shift, scale1p, eps=1e-6, keep_x=keep)
    torch.cuda.synchronize()
    assert (adaln_mod.adaln_norm.launches, adaln_mod.adaln_norm.plain_calls) == (launches + 1,
                                                                                 plain)
    want_x, want_z = adaln_mod.adaln_norm_plain(x, gate, y, shift, scale1p, eps=1e-6)
    hi = torch.float64 if dtype == torch.float32 else torch.float32
    up = [None if t is None else t.to(hi) for t in (x, gate, y, shift, scale1p)]
    _, ref_z = adaln_mod.adaln_norm_plain(*up, eps=1e-6)
    assert got_z.dtype == dtype and got_z.shape == x.shape
    if variant == "full":
        assert int((_bits(got_x) - _bits(want_x)).abs().max()) <= 1
    elif variant == "no_y":
        assert got_x is x
    else:
        assert got_x is None
    if dtype == torch.bfloat16:
        assert _rel_l2(got_z, ref_z) <= _rel_l2(want_z, ref_z)
    else:
        assert _rel_l2(got_z, ref_z) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("why", ["shape", "autograd records", "dtype"])
def test_adaln_norm_on_the_card_raises_where_the_kernel_cannot(cuda, why):
    """C % 8 != 0, a recording autograd, or float16: no launch, no
    composition, an error that names why."""
    c = 12 if why == "shape" else 16
    dtype = torch.float16 if why == "dtype" else torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(4)
    x, y = (torch.randn(2, 9, c, generator=g, device=cuda).to(dtype) for _ in range(2))
    gate, shift, scale1p = torch.randn(3, 2, c, generator=g, device=cuda).to(dtype)
    y.requires_grad_(why == "autograd records")
    assert adaln_mod.refusal(x, gate, y, shift, scale1p) == why
    counts = (adaln_mod.adaln_norm.launches, adaln_mod.adaln_norm.plain_calls,
              adaln_mod.adaln_norm_plain.ops)
    with pytest.raises(TypeError if why == "dtype" else ValueError, match=f"\\({why}\\)"):
        adaln_mod.adaln_norm(x, gate, y, shift, scale1p, eps=1e-6)
    assert (adaln_mod.adaln_norm.launches, adaln_mod.adaln_norm.plain_calls,
            adaln_mod.adaln_norm_plain.ops) == counts


# The main paths' residual maps: DDIM's super_small at batch 128 (C = 64,
# 128, 256 at 128, 64, 32 px) and SD-2.1's UNet at 16x16 latents, batch 256
# (C = 320, 640, 1280), and a ragged one
RESIDUAL_SHAPES = [(128, 128, 128, 64), (128, 64, 64, 128), (128, 32, 32, 256),
                   (256, 16, 16, 320), (256, 16, 16, 640), (256, 16, 16, 1280), (1, 3, 5, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", RESIDUAL_SHAPES)
def test_residual_bias_kernel_is_the_f32_sum_rounded_once(cuda, shape, dtype, two):
    """One launch, bit-equal to the plain version: ((x + h) + bias) + bias2
    in f32 rounded once (in f32 the sum itself; in bf16 one rounding of
    it, so within half a bf16 ulp of the exact sum)."""
    from phendiff_tpu_torch.ops import residual_bias as RB

    g = torch.Generator(device=cuda).manual_seed(6)
    x, h = (torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(2))
    b, b2 = (torch.randn(shape[-1], generator=g, device=cuda).to(dtype) for _ in range(2))
    b2 = b2 if two else None
    launches, plain = RB.residual_bias.launches, RB.residual_bias.plain_calls
    got = RB.residual_bias(x, h, b, b2)
    torch.cuda.synchronize()
    assert (RB.residual_bias.launches, RB.residual_bias.plain_calls) == (launches + 1, plain)
    want = x.float() + h.float() + b.float() + (0 if b2 is None else b2.float())
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, want.to(dtype))
    assert torch.equal(got, RB.residual_bias_plain(x, h, b, b2))


@pytest.mark.cuda
@pytest.mark.parametrize("why", ["shape", "autograd records", "dtype", "layout"])
def test_residual_bias_on_the_card_raises_where_the_kernel_cannot(cuda, why):
    """C % 8 != 0, a recording autograd, float16 or a transposed map: no
    launch, an error that names why."""
    from phendiff_tpu_torch.ops import residual_bias as RB

    c = 12 if why == "shape" else 16
    dtype = torch.float16 if why == "dtype" else torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(7)
    x, h = (torch.randn(2, 4, 6, c, generator=g, device=cuda).to(dtype) for _ in range(2))
    b = torch.randn(c, generator=g, device=cuda).to(dtype)
    if why == "layout":
        h = h.transpose(1, 2).contiguous().transpose(1, 2)
    h.requires_grad_(why == "autograd records")
    assert RB.refusal(x, h, b) == why
    launches = RB.residual_bias.launches
    with pytest.raises(TypeError if why == "dtype" else ValueError, match=f"\\({why}\\)"):
        RB.residual_bias(x, h, b)
    assert RB.residual_bias.launches == launches


@pytest.mark.cuda
def test_ddim_forward_defers_every_resnet_block_and_a_train_step_none(cuda):
    """The ddim_super_small_128 UNet in bf16: a batch-128 forward under
    no_grad launches the residual kernel once for each of its 17 ResnetBlocks
    (no plain call), and is as close to the forward that adds each bias in
    its conv (autograd recording) as bf16 rounding allows (FORWARD_REL_L2);
    under ``plain_kernels`` the blocks defer to the plain residual (no launch,
    no counted call); a train step's forward and backward defer none."""
    from phendiff_tpu_torch.core.precision import cast_matmul_weights
    from phendiff_tpu_torch.models.config import super_small
    from phendiff_tpu_torch.models.unet2d import CondUNet2D
    from phendiff_tpu_torch.ops.routes import launch_counts, plain_kernels

    model = CondUNet2D(super_small(), dtype=torch.bfloat16).init_weights(
        torch.Generator().manual_seed(0))
    with torch.no_grad():  # Flax's initialisers zero the biases: draw them
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1)
    model = cast_matmul_weights(model.to(cuda))
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(128, 128, 128, 3, generator=g, device=cuda)
    t = torch.randint(0, 1000, (128,), generator=g, device=cuda)
    labels = torch.arange(128, device=cuda) % 2
    keys = ("residual_bias", "residual_bias_plain_calls")

    def counted(fn):
        before = launch_counts()
        out = fn()
        torch.cuda.synchronize()
        after = launch_counts()
        return out, tuple(after[k] - before[k] for k in keys)

    with torch.no_grad():
        got, n = counted(lambda: model(x, t, class_labels=labels))
        assert n == (17, 0)
        with plain_kernels():
            plain, n = counted(lambda: model(x[:8], t[:8], class_labels=labels[:8]))
        assert n == (0, 0)
    assert _rel_l2(got[:8], plain) < FORWARD_REL_L2
    want, n = counted(lambda: model(x[:8], t[:8], class_labels=labels[:8]))
    assert n == (0, 0) and want.grad_fn is not None
    assert _rel_l2(got[:8], want.detach()) < FORWARD_REL_L2
    _, n = counted(lambda: want.float().square().mean().backward())
    assert n == (0, 0)


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
