"""Fused GroupNorm + affine + optional SiLU: hand-written Hopper kernels
for the forward and the backward, and their plain PyTorch versions.

Counterpart of ``phendiff_tpu/ops/gn_kernels.py`` (TPU kernel
``_gn_kernel``, launched by ``_pallas_gn``), with the semantics of the JAX
package's XLA GroupNorm path, the TPU default: f32 one-pass moments, the
``max(var, 0)`` clamp, f32 affine and SiLU, output in ``out_dtype``.  The
CUDA source, ``csrc/group_norm_silu.cu``, holds each (sample, channel
slice) tile in the shared memory of a thread-block cluster, so x is read
from HBM once; its header gives the design and the bound.  ``gn_plan``
picks the launch shape.  Where it has none (a tile whose rows do not fit 16
blocks' shared memory, such as the SD VAE's 512 px maps, or a group wider
than 256 channels), the call takes the streaming variant of the same
source: a split statistics pass, a fixed-order combine, and a second read
of x that normalises (the backward: split sums whose last block per sample
combines them, then a second read of x and g for dx).  ``gn_route`` says
which a shape takes.

``fused_group_norm`` launches the forward kernel for CUDA tensors (which
writes its output in the input's dtype, as every UNet call asks) and uses
``group_norm_plain`` only for CPU tensors.  On the card it is a
``torch.autograd.Function``: the forward also writes each (sample, group)'s
mean and rstd, and the backward is the backward kernel
(``fused_group_norm_bwd``), the closed form that ``group_norm_bwd_plain``
states in plain PyTorch.  The TPU package has no backward kernel (its
``_fused_gn_bwd`` recomputes the XLA reference under ``jax.vjp``).
``fused_group_norm.launches`` and ``fused_group_norm_bwd.launches`` count
cluster-kernel launches (one a call), ``.stream_launches`` the streaming
variant's calls (three kernels a forward call, two a backward call).
The forward cluster kernel also takes an optional addend [B, C] (a
ResnetBlock's time embedding): it normalises x + addend, the sum formed on
chip as the kernel reads x and rounded to x's dtype, so the sum is never
written out.  Where autograd records, or on the streaming route, the
wrapper forms the sum first (``route_addend``);
``fused_group_norm.addend_launches`` and ``.addend_materialised`` count the
two.  Every launch runs with the current device set to its input's
(``_build.on_tensor_device``), so a tensor on another card than the
current one launches, and sets the kernels up, on its own card.

``channel_moments`` is the counterpart of ``m_pallas`` in
``tools/bench_gn_moments.py``: per-channel f32 sum x and sum x^2 of a
[B, S, C] map, through the split statistics pass of the same CUDA source.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from phendiff_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Moments tool and streaming variant: splits of S per sample are chosen so a
# call has about this many blocks in all (a few waves over the H100's 132
# SMs).
_TARGET_BLOCKS = 1024
_MAX_CHANNELS = 4096

# Launch plan of the cluster kernels (limits as in csrc/group_norm_silu.cu).
SMEM_LIMIT = 232448  # 227 KB of shared memory a Hopper block can use
MAX_CLUSTER = 16  # blocks a cluster; above 8 is non-portable (H100 allows 16)
MAX_TILE_CHANNELS = 256


# Threads a block of the forward cluster kernel.
THREADS = 256


# The backward's blocks: threads, the narrowest tile row in bytes, at most
# this many bytes of x and g a block, and the samples a block takes chosen
# so that a call's blocks fit one wave of this many (three blocks an SM on
# the H100's 132 SMs).
_BWD_THREADS = 256
_BWD_ROW_BYTES = 32
_BWD_BLOCK_BYTES = 96 * 1024
_BWD_WAVE = 3 * 132
# A cluster of this many blocks, each taking more than a third of an SM's
# shared memory, splits again into twice as many blocks of half the threads
# (measured on the SD UNet's [8, 4096, 320] and [8, 4096, 640] maps, PERF.md;
# at 2 and 4 blocks the split was slower).
_BWD_SPLIT_AGAIN = 8


class GnPlan(NamedTuple):
    """Launch shape of the cluster kernels for one (S, C, G, dtype) and, in
    the backward, batch."""

    cb: int  # channels a tile: whole groups, a multiple of 8 dividing C
    k: int  # blocks a cluster; the tile's S rows split k ways
    rows: int  # rows of a sample a block holds (the last block may hold fewer)
    threads: int
    smem: int  # dynamic shared memory a block, bytes
    nb: int = 1  # samples a block holds (the backward, k = 1 only)


def _tile_bytes(rows: int, cb: int, itemsize: int) -> int:
    """Bytes of one tile of ``rows`` x ``cb``: whole TMA boxes of up to 256
    rows, 128-byte aligned (csrc ``tile_bytes``)."""
    box = min(rows, 256)
    return -(-(-(-rows // box) * box * cb * itemsize) // 128) * 128


def _smem_bytes(rows: int, cb: int, itemsize: int, threads: int) -> int:
    """Shared memory of one forward block, as the kernel lays it out: its
    tile, then the f32 reduction scratch, a ticket and 64 mbarriers."""
    return _tile_bytes(rows, cb, itemsize) + 4 * (2 * (threads // 32) * cb + 6 * cb) + 16 + 8 * 64


def _bwd_smem_bytes(nb: int, rows: int, cb: int, itemsize: int, threads: int) -> int:
    """Shared memory of one backward block holding ``nb`` samples of
    ``rows`` rows: the x and g tiles, then the f32 reduction scratch, scale
    and per-(sample, channel) sums and coefficients, a ticket and 64
    mbarriers (csrc ``bwd_smem_bytes``)."""
    return (2 * _tile_bytes(nb * rows, cb, itemsize)
            + 4 * (2 * (threads // 32) * cb + 3 * cb + 6 * nb * cb) + 16 + 8 * 64)


def _samples_per_block(batch: int, slices: int, sample_bytes: int) -> int:
    """Samples a backward block holds where one sample's tile fits a block:
    the fewest that bring the call's blocks within ``_BWD_WAVE``, as many
    as ``_BWD_BLOCK_BYTES`` allows; below the 8 warps of a block, a power of
    two, so the warps split evenly over them."""
    most = max(1, min(batch, _BWD_BLOCK_BYTES // sample_bytes))
    nb = min(most, -(-batch * slices // _BWD_WAVE))
    if nb < _BWD_THREADS // 32:
        nb = 1 << (nb - 1).bit_length()
        while nb > most:
            nb //= 2
    return nb


@functools.lru_cache(maxsize=1024)
def gn_plan(s: int, c: int, groups: int, itemsize: int, backward: bool = False,
            batch: int = 1) -> GnPlan:
    """The forward's (or, with ``backward``, the backward's) launch shape.

    A tile is one sample x ``cb`` channels: the fewest whole groups that
    make a multiple of 8 channels and a row of 64 bytes or more in the
    forward, 32 in the backward (or fewer channels, down to a multiple of
    8, where such a tile does not fit).  Its S rows (x, and g in the
    backward) are split over ``k`` blocks of a cluster, a power of two,
    until a block holds about 64 KB in the forward, 96 KB in the backward,
    so a few blocks share an SM; ``k`` stops at 16, where a block's share
    may exceed that.  Wider rows suit the forward, larger blocks the
    backward (PERF.md, section 6).  Where a sample's tile fits one backward
    block (``k`` = 1), a block holds ``nb`` samples of ``batch``
    (``_samples_per_block``), so small maps run in one wave of blocks; the
    route (``gn_route``) does not depend on ``batch``.  Raises ValueError
    where no plan fits (a tile wider than 256 channels, or rows that do not
    fit 16 blocks' shared memory).
    """
    if c % groups or c % 8:
        raise ValueError(
            f"group_norm kernels need C % 8 == 0 and C % G == 0; got C={c}, G={groups}")
    unit = math.lcm(8, c // groups)
    widths = [m for m in range(unit, min(c, MAX_TILE_CHANNELS) + 1, unit) if c % m == 0]
    if not widths:
        raise ValueError(f"group_norm kernels hold at most {MAX_TILE_CHANNELS} channels a tile; "
                         f"C={c}, G={groups} needs {unit}")
    block_bytes, row_bytes = ((_BWD_BLOCK_BYTES, _BWD_ROW_BYTES) if backward
                              else (64 * 1024, 64))
    first = next((i for i, m in enumerate(widths) if m * itemsize >= row_bytes),
                 len(widths) - 1)
    arrays = 2 if backward else 1
    for cb in widths[first::-1]:  # the preferred width, then narrower ones
        tile = arrays * cb * s * itemsize
        k = 1
        while k < MAX_CLUSTER and 2 * k <= s and k * block_bytes < tile:
            k *= 2
        rows = -(-s // k)
        k = -(-s // rows)  # no empty block
        if not backward:
            smem = _smem_bytes(rows, cb, itemsize, THREADS)
            if smem <= SMEM_LIMIT:
                return GnPlan(cb, k, rows, THREADS, smem)
            continue
        nb = 1
        threads = _BWD_THREADS
        if (k == _BWD_SPLIT_AGAIN and 2 * k <= s
                and _bwd_smem_bytes(1, rows, cb, itemsize, threads) > SMEM_LIMIT // 3):
            k, threads = 2 * k, threads // 2
            rows = -(-s // k)
            k = -(-s // rows)
        if k == 1 and _bwd_smem_bytes(1, rows, cb, itemsize, threads) <= SMEM_LIMIT:
            nb = _samples_per_block(batch, c // cb, tile + 24 * cb)
            while _bwd_smem_bytes(nb, rows, cb, itemsize, threads) > SMEM_LIMIT:
                nb = nb - 1 if nb > threads // 32 else nb // 2
        smem = _bwd_smem_bytes(nb, rows, cb, itemsize, threads)
        if smem <= SMEM_LIMIT:
            return GnPlan(cb, k, rows, threads, smem, nb)
    raise ValueError(f"group_norm kernels: S={s} rows of {widths[0]} channels do not fit "
                     f"{MAX_CLUSTER} blocks' shared memory ({smem} > {SMEM_LIMIT} bytes)")


def gn_route(s: int, c: int, groups: int, itemsize: int, backward: bool = False) -> str:
    """``"cluster"`` where ``gn_plan`` has a plan for the call, else
    ``"stream"``: the kernel a CUDA call of this shape launches."""
    try:
        gn_plan(s, c, groups, itemsize, backward)
    except ValueError:
        return "stream"
    return "cluster"


def _grouped_stats(xf: torch.Tensor, eps: float):
    """Mean and rstd [B, G] of an f32 [B, S, G, C/G] map: the one-pass
    moments with the ``max(var, 0)`` clamp."""
    mean = xf.mean(dim=(1, 3))
    var = (xf.square().mean(dim=(1, 3)) - mean.square()).clamp_min(0.0)
    return mean, torch.rsqrt(var + eps)


def group_stats_plain(x: torch.Tensor, num_groups: int, eps: float):
    """Per (sample, group) f32 mean and rstd of [B, S, C], each [B, G], as
    ``group_norm_plain`` computes them."""
    b, s, c = x.shape
    return _grouped_stats(x.float().reshape(b, s, num_groups, c // num_groups), eps)


def group_norm_plain(
    x: torch.Tensor,  # [B, S, C]
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    *,
    num_groups: int,
    eps: float,
    act: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
    addend: Optional[torch.Tensor] = None,  # [B, C]
) -> torch.Tensor:
    """GroupNorm over [B, S, C] with the JAX package's XLA-path semantics;
    with ``addend``, of ``x + addend[:, None, :]`` (PyTorch's add, so a sum
    of two bf16 tensors is rounded to bf16)."""
    if addend is not None:
        x = x + addend[:, None, :]
    b, s, c = x.shape
    xf = x.float().reshape(b, s, num_groups, c // num_groups)
    mean, rstd = _grouped_stats(xf, eps)
    xf = ((xf - mean[:, None, :, None]) * rstd[:, None, :, None]).reshape(b, s, c)
    if scale is not None:
        xf = xf * scale.float()
    if bias is not None:
        xf = xf + bias.float()
    if act == "silu":
        xf = F.silu(xf)
    elif act is not None:
        raise ValueError(f"unknown activation: {act}")
    return xf.to(out_dtype or torch.float32)


def group_norm_bwd_plain(
    x: torch.Tensor,  # [B, S, C]
    g: torch.Tensor,  # [B, S, C], the output gradient
    scale: torch.Tensor,  # [C]
    bias: torch.Tensor,  # [C]
    mean: torch.Tensor,  # [B, G], the forward's
    rstd: torch.Tensor,  # [B, G]
    *,
    num_groups: int,
    act: Optional[str] = None,
):
    """(dx in x's dtype, dscale, dbias in f32) of ``group_norm_plain`` with
    scale and bias, in closed form from the forward's mean and rstd, f32:

    x^ = (x - mean) rstd, z = scale x^ + bias, dz = g (SiLU: times
    sigma(z) (1 + z (1 - sigma(z)))), A = sum_s dz and B = sum_s dz x^ per
    (sample, channel), a = sum_c scale A / N and b = sum_c scale B / N per
    (sample, group) with N = S C/G, dx = rstd (scale dz - a - x^ b),
    dbias = sum_b A, dscale = sum_b B.
    """
    bsz, s, c = x.shape
    cg = c // num_groups
    grouped = (bsz, s, num_groups, cg)
    mu, rs = mean.float()[:, None, :, None], rstd.float()[:, None, :, None]
    sc = scale.float().reshape(num_groups, cg)
    xh = (x.float().reshape(grouped) - mu) * rs
    dz = g.float().reshape(grouped)
    if act == "silu":
        z = xh * sc + bias.float().reshape(num_groups, cg)
        sg = torch.sigmoid(z)
        dz = dz * sg * (1 + z * (1 - sg))
    elif act is not None:
        raise ValueError(f"unknown activation: {act}")
    a_c, b_c = dz.sum(dim=1), (dz * xh).sum(dim=1)  # [B, G, cg]
    n = s * cg
    a = (sc * a_c).sum(dim=-1)[:, None, :, None] / n
    b = (sc * b_c).sum(dim=-1)[:, None, :, None] / n
    dx = rs * (sc * dz - a - xh * b)
    return (dx.reshape(bsz, s, c).to(x.dtype), b_c.sum(dim=0).reshape(c),
            a_c.sum(dim=0).reshape(c))


@functools.cache
def _fwd_entry():
    fn = _build.load("group_norm_silu").phd_gn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    return fn


@functools.cache
def _bwd_entry():
    fn = _build.load("group_norm_silu").phd_gn_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
        + [ctypes.c_void_p]
    )
    return fn


@functools.cache
def _stream_fwd_entry():
    fn = _build.load("group_norm_silu").phd_gn_stream_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
        + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    return fn


@functools.cache
def _stream_bwd_entry():
    fn = _build.load("group_norm_silu").phd_gn_stream_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
        + [ctypes.c_void_p]
    )
    return fn


@functools.cache
def _occupancy_entry():
    fn = _build.load("group_norm_silu").phd_gn_max_active_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 9
    return fn


@functools.cache
def _moments_entry():
    fn = _build.load("group_norm_silu").phd_channel_moments
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    return fn


# Tickets the backward kernels take: one a channel slice in the cluster
# kernel (at most C / 8), one a sample and one more in the streaming variant
# (B + 1, B < 65536).
_TICKETS = 1 << 16


@functools.cache
def _tickets(device: torch.device) -> torch.Tensor:
    """The backward kernels' tickets: zeroed once, and left zeroed by every
    launch."""
    return torch.zeros(_TICKETS, dtype=torch.int32, device=device)


def _check_input(x: torch.Tensor, num_groups: int = 1) -> torch.Tensor:
    """The kernels' constraints on x; returns x contiguous."""
    c = x.shape[-1]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"group_norm kernels take bf16 or f32, got {x.dtype}")
    if c % 8 or c % num_groups or c > _MAX_CHANNELS:
        raise ValueError(
            f"group_norm kernels need C % 8 == 0, C % G == 0, C <= {_MAX_CHANNELS}; "
            f"got C={c}, G={num_groups}"
        )
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("group_norm kernels need a 16-byte aligned input")
    return x


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def max_active_clusters(b, s, c, num_groups, dtype, act=None, backward=False) -> int:
    """How many clusters of the plan for this call the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    plan = gn_plan(s, c, num_groups, dtype.itemsize, backward, b if backward else 1)
    n = _occupancy_entry()(int(backward), _DTYPE_CODES[dtype], int(act == "silu"),
                           -(-b // plan.nb), c, plan.cb, plan.k, plan.threads, plan.smem)
    if n < 0:
        _build.check(-n, "group_norm occupancy query")
    return n


@_build.on_tensor_device
def _launch(x, scale, bias, num_groups, eps, act, out_dtype, addend=None):
    """Forward kernel, the cluster one or the streaming variant as
    ``gn_route`` says: (out, mean, rstd), mean and rstd f32 [B, G].  An
    ``addend`` ([B, C] in x's dtype, the cluster route only) is added to x
    inside the kernel, the sum rounded to x's dtype."""
    b, s, c = x.shape
    if out_dtype != x.dtype:
        raise TypeError(
            f"group_norm kernel maps f32 -> f32 or bf16 -> bf16, got {x.dtype} -> {out_dtype}"
        )
    if scale is None or bias is None:
        raise ValueError("group_norm kernel needs scale and bias")
    if act not in (None, "silu"):
        raise ValueError(f"unknown activation: {act}")
    x = _check_input(x, num_groups)
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    if addend is not None:
        if addend.shape != (b, c) or addend.dtype != x.dtype:
            raise ValueError(f"addend must be [B, C] = [{b}, {c}] in {x.dtype}, got "
                             f"{tuple(addend.shape)} in {addend.dtype}")
        addend = _check_input(addend.to(x.device))
    out = torch.empty((b, s, c), dtype=out_dtype, device=x.device)
    stats = torch.empty((2, b, num_groups), dtype=torch.float32, device=x.device)
    if gn_route(s, c, num_groups, x.element_size()) == "stream":
        if addend is not None:
            raise ValueError("the streaming group_norm variant takes no addend")
        nsplit = _stream_splits(b, s, c, x.element_size())
        work = torch.empty(2 * b * nsplit * c, dtype=torch.float32, device=x.device)
        err = _stream_fwd_entry()(
            x.data_ptr(), _DTYPE_CODES[x.dtype], scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), work.data_ptr(),
            b, s, c, num_groups, float(eps), int(act == "silu"), nsplit, _stream(x),
        )
        _build.check(err, "group_norm_silu stream launch")
        fused_group_norm.stream_launches += 1
        return out, stats[0], stats[1]
    plan = gn_plan(s, c, num_groups, x.element_size())
    err = _fwd_entry()(
        x.data_ptr(), None if addend is None else addend.data_ptr(), _DTYPE_CODES[x.dtype],
        scale.data_ptr(), bias.data_ptr(), out.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), b, s, c, num_groups, float(eps), int(act == "silu"),
        plan.cb, plan.k, plan.threads, plan.smem, _stream(x),
    )
    _build.check(err, "group_norm_silu launch")
    fused_group_norm.launches += 1
    fused_group_norm.addend_launches += addend is not None
    return out, stats[0], stats[1]


@_build.on_tensor_device
def fused_group_norm_bwd(x, g, scale, bias, mean, rstd, *, num_groups, act=None):
    """(dx in x's dtype, dscale, dbias in f32) from the backward kernel (the
    cluster one, with ``gn_plan``'s launch shape for this batch, or the
    streaming variant, as ``gn_route`` says), for CUDA inputs: x as the
    forward took it, the output gradient ``g``, and the forward's mean and
    rstd ([B, G], ``_launch``).  Deterministic; allocates only outputs and
    workspace, and never synchronises the host."""
    b, s, c = x.shape
    if act not in (None, "silu"):
        raise ValueError(f"unknown activation: {act}")
    x = _check_input(x, num_groups)
    if not g.is_contiguous():
        fused_group_norm_bwd.g_copies += 1
    g = _check_input(g.to(x.dtype), num_groups)
    if g.shape != x.shape:
        raise ValueError(f"output gradient {tuple(g.shape)} != input {tuple(x.shape)}")
    mean, rstd = (t.to(device=x.device, dtype=torch.float32).contiguous() for t in (mean, rstd))
    if mean.shape != (b, num_groups) or rstd.shape != (b, num_groups):
        raise ValueError(f"mean and rstd must be [B, G] = [{b}, {num_groups}]")
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    dx = torch.empty_like(x)
    dparams = torch.empty((2, c), dtype=torch.float32, device=x.device)
    if gn_route(s, c, num_groups, x.element_size(), backward=True) == "stream":
        nsplit, kc, rows, nsplit_dx = _stream_bwd_plan(b, s, c, x.element_size())
        work = torch.empty(2 * b * (nsplit // kc) * c + 2 * b * c + 2 * b * num_groups,
                           dtype=torch.float32, device=x.device)
        err = _stream_bwd_entry()(
            x.data_ptr(), g.data_ptr(), _DTYPE_CODES[x.dtype], scale.data_ptr(),
            bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            dparams[0].data_ptr(), dparams[1].data_ptr(), work.data_ptr(),
            _tickets(x.device).data_ptr(), b, s, c, num_groups, int(act == "silu"), nsplit, kc,
            rows, nsplit_dx, _stream(x),
        )
        _build.check(err, "group_norm_silu_bwd stream launch")
        fused_group_norm_bwd.stream_launches += 1
        return dx, dparams[0], dparams[1]
    plan = gn_plan(s, c, num_groups, x.element_size(), backward=True, batch=b)
    sums = torch.empty((2, -(-b // plan.nb), c), dtype=torch.float32, device=x.device)
    err = _bwd_entry()(
        x.data_ptr(), g.data_ptr(), _DTYPE_CODES[x.dtype], scale.data_ptr(), bias.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), dparams[0].data_ptr(),
        dparams[1].data_ptr(), sums.data_ptr(), _tickets(x.device).data_ptr(),
        b, s, c, num_groups, int(act == "silu"), plan.cb, plan.k, plan.nb, plan.threads,
        plan.smem, _stream(x),
    )
    _build.check(err, "group_norm_silu_bwd launch")
    fused_group_norm_bwd.launches += 1
    return dx, dparams[0], dparams[1]


class _FusedGroupNorm(torch.autograd.Function):
    """The forward kernel, saving each (sample, group)'s mean and rstd, and
    the backward kernel: dx in x's dtype, f32 dscale and dbias."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, act, out_dtype):
        out, mean, rstd = _launch(x, scale, bias, num_groups, eps, act, out_dtype)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.kw = dict(num_groups=num_groups, act=act)
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = fused_group_norm_bwd(x, g, scale, bias, mean, rstd, **ctx.kw)
        return dx, dscale, dbias, None, None, None, None


def _records(*tensors) -> bool:
    """Whether autograd records a graph through any of ``tensors``."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def route_addend(x, scale, bias, addend, num_groups):
    """The (x, addend) a CUDA call hands the forward kernel.  The addend
    goes into the kernel where no autograd graph is recorded (the backward
    kernel takes none), the cluster route holds the shape and the addend is
    in x's dtype; otherwise the sum ``x + addend[:, None, :]`` is formed
    first, as the caller would have (``.addend_materialised``), and the
    addend is None."""
    _, s, c = x.shape
    if (not _records(x, scale, bias, addend) and addend.dtype == x.dtype
            and gn_route(s, c, num_groups, x.element_size()) == "cluster"):
        return x, addend
    fused_group_norm.addend_materialised += 1
    return x + addend[:, None, :], None


def fused_group_norm(
    x: torch.Tensor,  # [B, S, C]
    scale: Optional[torch.Tensor],  # [C]
    bias: Optional[torch.Tensor],  # [C]
    *,
    num_groups: int,
    eps: float,
    act: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
    addend: Optional[torch.Tensor] = None,  # [B, C]
) -> torch.Tensor:
    """GroupNorm (+ affine + SiLU) over [B, S, C], differentiable; with
    ``addend``, of ``x + addend[:, None, :]``.

    A CUDA tensor goes through the kernels (``out_dtype`` equal to x's; the
    cluster kernels or, where ``gn_route`` says so, the streaming variant)
    or raises; a CPU tensor goes through ``group_norm_plain``.  On the card
    the addend goes into the forward kernel where it can
    (``.addend_launches``); elsewhere the sum is formed first
    (``.addend_materialised``), as ``route_addend`` says.  Both give the
    same bits.
    """
    out_dtype = out_dtype or torch.float32
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, num_groups=num_groups, eps=eps, act=act,
                                out_dtype=out_dtype, addend=addend)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm runs on cuda or cpu, not {x.device}")
    if addend is not None:
        x, addend = route_addend(x, scale, bias, addend, num_groups)
    if _records(x, scale, bias):
        return _FusedGroupNorm.apply(x, scale, bias, num_groups, eps, act, out_dtype)
    return _launch(x, scale, bias, num_groups, eps, act, out_dtype, addend)[0]


def _num_splits(b: int, s: int, c: int) -> int:
    cvn = c // 8
    rows_per_block_pass = 1 if cvn >= 256 else 256 // cvn
    max_splits = -(-s // rows_per_block_pass)
    return max(1, min(max_splits, -(-_TARGET_BLOCKS // b)))


def _stream_splits(b: int, s: int, c: int, itemsize: int) -> int:
    """Splits of S a sample for the streaming variant: ``_num_splits``'
    count, but at most one per 256 bytes of a channel's column, so the f32
    partial sums (8 bytes a channel a split) stay within 1/32 of x."""
    return max(1, min(_num_splits(b, s, c), s * itemsize // 256))


# The streaming backward: a sums grid of at most _STREAM_SMALL_GRID blocks
# (fewer than the H100's SMs, as at batch 1) takes blocks of 512 threads,
# more loads in flight where there are few blocks, and a larger one keeps
# 256, two blocks an SM.  A grid within two such waves first adds its sums
# over clusters of 8 blocks, so the last block of a sample reads 8 times
# fewer partial sums; a larger grid does without (co-scheduling clusters
# cost it more than the last blocks' reads).  Such a grid also takes at
# most _STREAM_SMALL_SPLITS splits a sample (measured best at batch 1 on
# the SD maps, PERF.md): fewer, wider blocks and a shorter last block.
_STREAM_SMALL_GRID = 132
_STREAM_SMALL_SPLITS = 64


def _stream_bwd_plan(b: int, s: int, c: int, itemsize: int):
    """(nsplit, kc, R, nsplit_dx) of the streaming backward: the sums pass's
    splits of S a sample (``_stream_splits``, a multiple of 8 from 8 on),
    the clusters of kc blocks that first add their sums, rows a block pass
    of it (R rows of C/8 threads), and the dx pass's splits (as many as the
    sums pass's, more at small batch: up to 256 blocks of at least 16
    rows)."""
    nsplit = _stream_splits(b, s, c, itemsize)
    if b * nsplit <= 2 * _STREAM_SMALL_GRID:
        nsplit = min(nsplit, _STREAM_SMALL_SPLITS)
    if nsplit > 8:
        nsplit -= nsplit % 8
    grid = b * nsplit
    rows = max(1, (512 if grid <= _STREAM_SMALL_GRID else 256) // (c // 8))
    kc = min(nsplit, 8) if grid <= 2 * _STREAM_SMALL_GRID else 1
    nsplit_dx = max(nsplit, min(-(-s // 16), -(-256 // b)))
    return nsplit, kc, rows, nsplit_dx


def channel_moments_plain(x: torch.Tensor, tile: int = 512):
    """Per-channel f32 (sum x, sum x^2) over the S axis of [B, S, C], as the
    TPU kernel computes them: f32 accumulators carried across S-tiles."""
    b, _, c = x.shape
    s = torch.zeros(b, c, dtype=torch.float32, device=x.device)
    q = torch.zeros_like(s)
    for t in x.split(tile, dim=1):
        tf = t.float()
        s += tf.sum(dim=1)
        q += tf.square().sum(dim=1)
    return s, q


@_build.on_tensor_device
def channel_moments(x: torch.Tensor):
    """Per-channel f32 (sum x, sum x^2), each [B, C], of a [B, S, C] map.

    A CUDA tensor (bf16 or f32, C % 8 == 0) goes through the kernel (a
    split statistics pass plus a fixed-order combine, deterministic) or
    raises; a CPU tensor goes through ``channel_moments_plain``.
    """
    if x.device.type == "cpu":
        return channel_moments_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"channel_moments runs on cuda or cpu, not {x.device}")
    b, s, c = x.shape
    x = _check_input(x)
    nsplit = _num_splits(b, s, c)
    work = torch.empty(2 * b * nsplit * c, dtype=torch.float32, device=x.device)
    out = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    err = _moments_entry()(
        x.data_ptr(), _DTYPE_CODES[x.dtype], work.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), b, s, c, nsplit, _stream(x),
    )
    _build.check(err, "channel_moments launch")
    channel_moments.launches += 1
    return out[0], out[1]


fused_group_norm.launches = 0
fused_group_norm.stream_launches = 0
fused_group_norm.addend_launches = 0  # forward launches that took an addend
fused_group_norm.addend_materialised = 0  # calls with an addend that formed the sum first
fused_group_norm_bwd.launches = 0
fused_group_norm_bwd.stream_launches = 0
fused_group_norm_bwd.g_copies = 0  # output gradients the backward had to make contiguous
channel_moments.launches = 0
