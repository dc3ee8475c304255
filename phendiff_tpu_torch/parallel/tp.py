"""Tensor parallelism: parameters sharded over the ``model`` axis.

Counterpart of ``phendiff_tpu/parallel/tp.py``.  The JAX module shards the
parameters by name and lets GSPMD place the activations and insert the
collectives; here each process of a replica holds its shards and runs its
part of every sharded block, and the collectives are explicit autograd
functions over the model group (``parallel/mesh.py``):

* ``copy_in``: identity forward, all-reduce backward, where a replicated
  tensor enters a per-rank computation (so replicated leaves and
  activations get the same, whole gradient on every model rank);
* ``reduce_out``: all-reduce forward, identity backward, after a
  row-parallel layer;
* ``gather_channels``: all-gather of the last axis forward, this rank's
  slice backward, after a layer sharded only on its outputs.

The name rules are the JAX module's (``tp_spec``, on Flax paths and Flax
shapes, returning a PartitionSpec as a tuple): column-parallel ``qkv`` /
``to_q`` / ``to_k`` / ``to_v`` / ``proj_in`` Dense kernels and ``conv1`` /
``conv_in`` / ``conv`` conv kernels, row-parallel ``to_out`` / ``proj_out``
and ``conv2``, everything else replicated, and a dimension the model size
does not divide replicated.  ``shard_module`` marks the blocks of a model
that run on shards and returns the plan: each sharded torch parameter's
axis and its number of fused parts.  A block runs on shards where its
leaves are sharded by those rules and where its shards are whole units:

* ``ResnetBlock``: ``conv1`` column, ``conv2`` row, the ``temb``
  projection's and ``norm2``'s slices, and ``norm2``'s groups over the
  rank's channels (only where ``groups % model_size == 0``);
* ``SelfAttention2D``: the rank's heads of q, k and v, ``proj_out`` row
  (only where the heads divide).  JAX cuts the fused ``qkv`` kernel
  contiguously across the q/k/v seam; the port's rank holds the same
  number of columns as per-head slices, its heads of q, then of k, then of
  v (``parts`` 3), so the fused attention runs on ``[B, S, H/mp, D]``, the
  counterpart of ``set_tp_mesh``'s ``shard_map``, with no collective
  inside;
* the SD family's ``CrossAttention`` (``to_q``/``to_k``/``to_v`` column,
  cross-attention k and v from the replicated context, ``to_out`` row) and
  GEGLU (``proj_in`` column as matching halves of h and gate, ``parts``
  2; ``proj_out`` row);
* ``conv_in``, the down/upsample ``conv`` and ``Transformer2D.proj_in``
  are sharded on their outputs and gathered, since the next layer needs
  the full width; ``Transformer2D.proj_out`` is row-parallel over a slice
  of its replicated input.

Every other leaf, and each leaf of a block that cannot run on shards, stays
whole on every rank.  Checkpoints, the EMA pipeline and ``to_flax_params``
always see full tensors (``gather_params``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from phendiff_tpu_torch.parallel import mesh
from phendiff_tpu_torch.parallel.mesh import MODEL_AXIS

# Dense kernels are [in, out]; conv kernels are [kh, kw, in, out] (Flax).
_COLUMN_DENSE = {"qkv", "to_q", "to_k", "to_v", "proj_in"}
_ROW_DENSE = {"to_out", "proj_out"}
_COLUMN_CONV = {"conv1", "conv_in", "conv"}  # "conv" = down/upsample convs
_ROW_CONV = {"conv2"}
_EMBEDDING_SCOPES = ("class_embedding", "embedding")  # models/convert.py's


def tp_spec(path_names: Sequence[str], shape: Sequence[int], tp_size: int,
            axis: str = MODEL_AXIS) -> Tuple[Optional[str], ...]:
    """PartitionSpec (as a tuple; ``()`` is replicated) of one Flax leaf, by
    its path and shape: the JAX module's rules."""
    if tp_size <= 1 or not shape:
        return ()
    names = tuple(path_names)
    leaf = names[-1] if names else ""
    owner = names[-2] if len(names) >= 2 else ""
    if leaf != "kernel":
        return ()  # biases, norms, embeddings: replicated
    if len(shape) == 2:
        if owner in _COLUMN_DENSE and shape[1] % tp_size == 0:
            return (None, axis)
        if owner in _ROW_DENSE and shape[0] % tp_size == 0:
            return (axis, None)
        return ()
    if len(shape) == 4:
        if owner in _ROW_CONV and shape[2] % tp_size == 0:
            return (None, None, axis, None)
        if owner in _COLUMN_CONV and shape[3] % tp_size == 0:
            return (None, None, None, axis)
        return ()
    return ()


def flax_leaf(name: str, shape: Sequence[int]) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """A torch parameter's Flax path and shape (``models/convert.py``'s
    mapping: conv OIHW -> HWIO, Dense [out, in] -> [in, out])."""
    *scope, leaf = name.split(".")
    shape = tuple(shape)
    if leaf == "weight" and scope[-1:] and scope[-1] in _EMBEDDING_SCOPES:
        return (*scope, "embedding"), shape
    if leaf == "weight" and len(shape) == 4:
        o, i, kh, kw = shape
        return (*scope, "kernel"), (kh, kw, i, o)
    if leaf == "weight" and len(shape) == 2:
        return (*scope, "kernel"), (shape[1], shape[0])
    return (*scope, leaf), shape


def torch_axis(name: str, shape: Sequence[int], tp_size: int) -> Optional[int]:
    """The torch axis ``tp_spec`` shards of a torch parameter, or None."""
    path, fshape = flax_leaf(name, shape)
    spec = tp_spec(path, fshape, tp_size)
    if not any(spec):
        return None
    flax_dim = next(i for i, s in enumerate(spec) if s is not None)
    # HWIO's out (3) and in (2) are OIHW's 0 and 1; [in, out]'s 1 and 0 likewise
    return {4: {3: 0, 2: 1}, 2: {1: 0, 0: 1}}[len(fshape)][flax_dim]


def describe(params: Mapping[str, torch.Tensor], tp_size: int) -> str:
    """The non-replicated leaves of a torch parameter tree, one a line: torch
    name, full shape, Flax PartitionSpec."""
    lines = []
    for name, t in params.items():
        path, fshape = flax_leaf(name, t.shape)
        spec = tp_spec(path, fshape, tp_size)
        if any(spec):
            lines.append(f"{name}  {tuple(t.shape)}  {spec}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Collectives with gradients, over the model group
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    """SUM over the model group, accumulated in float32 (a bf16 partial sum
    would round once more than the unsharded layer does)."""
    y = x.float().contiguous() if x.dtype in (torch.bfloat16, torch.float16) else x.clone()
    dist.all_reduce(y, group=mesh.model_group())
    return y.to(x.dtype)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g)


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.width = x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.model_size())]
        dist.all_gather(parts, x, group=mesh.model_group())
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g.narrow(-1, mesh.model_rank() * w, w).contiguous()


def copy_in(x: torch.Tensor) -> torch.Tensor:
    return _CopyIn.apply(x)


def reduce_out(x: torch.Tensor) -> torch.Tensor:
    return _ReduceOut.apply(x)


def gather_channels(x: torch.Tensor) -> torch.Tensor:
    return _GatherChannels.apply(x)


# ---------------------------------------------------------------------------
# Shards of a tensor: ``parts`` fused pieces along ``dim``, each cut in
# ``size`` contiguous slices, the rank's slice of every piece side by side
# ---------------------------------------------------------------------------

def local_slice(t: torch.Tensor, dim: int, parts: int, size: int, rank: int) -> torch.Tensor:
    piece = t.shape[dim] // parts
    n = piece // size
    cut = [t.narrow(dim, k * piece + rank * n, n) for k in range(parts)]
    return cut[0] if parts == 1 else torch.cat(cut, dim)


def join_slices(shards: Sequence[torch.Tensor], dim: int, parts: int) -> torch.Tensor:
    """The full tensor from every rank's ``local_slice``, in rank order."""
    n = shards[0].shape[dim] // parts
    return torch.cat([s.narrow(dim, k * n, n) for k in range(parts) for s in shards], dim)


@dataclasses.dataclass(frozen=True)
class Shard:
    """A block's place on the model axis: ``size`` ranks, this one ``rank``."""

    size: int
    rank: int

    def slice(self, t: torch.Tensor, parts: int = 1, dim: int = -1) -> torch.Tensor:
        """This rank's slice of a replicated tensor that enters a per-rank
        computation (its gradient is summed over the model group)."""
        return local_slice(copy_in(t), dim % t.ndim, parts, self.size, self.rank)


# ---------------------------------------------------------------------------
# Layers on shards.  ``layer`` holds this rank's weight (functional_call
# hands the shard in) and the whole bias.
# ---------------------------------------------------------------------------

def _cast(t: Optional[torch.Tensor], dt) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dt)


def column_linear(shard: Shard, x: torch.Tensor, layer, parts: int = 1) -> torch.Tensor:
    """``layer`` over replicated ``x``, this rank's output features."""
    bias = None if layer.bias is None else shard.slice(layer.bias, parts)
    return F.linear(copy_in(x), layer.weight.to(x.dtype), _cast(bias, x.dtype))


def row_linear(x_local: torch.Tensor, layer) -> torch.Tensor:
    """``layer`` over this rank's input features, summed over the ranks."""
    y = reduce_out(F.linear(x_local, layer.weight.to(x_local.dtype)))
    return y if layer.bias is None else y + layer.bias.to(y.dtype)


def column_conv(shard: Shard, x: torch.Tensor, conv) -> torch.Tensor:
    """An NHWC ``Conv`` over replicated ``x``, this rank's output channels."""
    y = F.conv2d(copy_in(x).permute(0, 3, 1, 2), conv.weight.to(x.dtype),
                 shard.slice(conv.bias).to(x.dtype), conv.stride, conv.padding)
    return y.permute(0, 2, 3, 1)


def row_conv(x_local: torch.Tensor, conv) -> torch.Tensor:
    """An NHWC ``Conv`` over this rank's input channels, summed over the ranks."""
    y = F.conv2d(x_local.permute(0, 3, 1, 2), conv.weight.to(x_local.dtype), None,
                 conv.stride, conv.padding).permute(0, 2, 3, 1)
    return reduce_out(y) + conv.bias.to(y.dtype)


# ---------------------------------------------------------------------------
# The plan: which blocks run on shards, and each sharded parameter's layout
# ---------------------------------------------------------------------------

Plan = Dict[str, Tuple[int, int]]  # torch parameter name -> (axis, parts)


def shard_module(model: torch.nn.Module, size: Optional[int] = None,
                 rank: Optional[int] = None, prefix: str = "") -> Plan:
    """Mark the blocks of ``model`` (a ``CondUNet2D`` or an ``SDUNet``) that
    run on shards at model size ``size`` (``mesh.model_size()``), as rank
    ``rank``, and return the plan, its names under ``prefix``.  At size 1
    nothing is marked and the plan is empty."""
    from phendiff_tpu_torch.models.sd_unet import (
        CrossAttention,
        GEGLUFeedForward,
        Transformer2D,
    )
    from phendiff_tpu_torch.models.unet2d import (
        Downsample2D,
        ResnetBlock,
        SelfAttention2D,
        Upsample2D,
    )

    size = mesh.model_size() if size is None else size
    rank = mesh.model_rank() if rank is None else rank
    plan: Plan = {}
    if size <= 1:
        return plan
    shard = Shard(size, rank)

    def axis(mod_name: str, p: str, want: int) -> bool:
        w = getattr(model.get_submodule(mod_name), p) if mod_name else getattr(model, p)
        name = f"{mod_name}.{p}.weight" if mod_name else f"{p}.weight"
        return torch_axis(name, w.weight.shape, size) == want

    def take(mod_name: str, layers: Mapping[str, Tuple[int, int]]) -> None:
        for p, (ax, parts) in layers.items():
            plan[f"{prefix}{mod_name}.{p}.weight" if mod_name else f"{prefix}{p}.weight"] = (
                ax, parts)

    for name, m in model.named_modules():
        if isinstance(m, ResnetBlock):
            if (axis(name, "conv1", 0) and axis(name, "conv2", 1)
                    and m.groups2 % size == 0):
                m.tp = shard
                take(name, {"conv1": (0, 1), "conv2": (1, 1)})
        elif isinstance(m, SelfAttention2D):
            if axis(name, "qkv", 0) and axis(name, "proj_out", 1) and m.num_heads % size == 0:
                m.tp = shard
                take(name, {"qkv": (0, 3), "proj_out": (1, 1)})
        elif isinstance(m, CrossAttention):
            col = all(axis(name, p, 0) for p in ("to_q", "to_k", "to_v"))
            if col and axis(name, "to_out", 1) and m.num_heads % size == 0:
                m.tp = shard
                take(name, {"to_q": (0, 1), "to_k": (0, 1), "to_v": (0, 1), "to_out": (1, 1)})
        elif isinstance(m, GEGLUFeedForward):
            half = m.proj_out.in_features
            if axis(name, "proj_in", 0) and axis(name, "proj_out", 1) and half % size == 0:
                m.tp = shard
                take(name, {"proj_in": (0, 2), "proj_out": (1, 1)})
        elif isinstance(m, Transformer2D):
            if m.use_linear:
                m.tp_in = shard if axis(name, "proj_in", 0) else None
                m.tp_out = shard if axis(name, "proj_out", 1) else None
                take(name, {p: ax for p, ax, on in (("proj_in", (0, 1), m.tp_in),
                                                      ("proj_out", (1, 1), m.tp_out)) if on})
        elif isinstance(m, (Downsample2D, Upsample2D)):
            if axis(name, "conv", 0):
                m.tp = shard
                take(name, {"conv": (0, 1)})
    if axis("", "conv_in", 0):
        model.tp_conv_in = shard
        take("", {"conv_in": (0, 1)})
    return plan


def shard_params(params: Mapping[str, torch.Tensor], plan: Plan,
                 size: Optional[int] = None, rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """This rank's tensors of a full parameter tree: the plan's leaves cut
    (new tensors, keeping ``requires_grad``), the others as they are."""
    size = mesh.model_size() if size is None else size
    rank = mesh.model_rank() if rank is None else rank
    out = {}
    for n, t in params.items():
        if n in plan:
            dim, parts = plan[n]
            with torch.no_grad():
                local = local_slice(t, dim, parts, size, rank).clone()
            t = local.requires_grad_(t.requires_grad)
        out[n] = t
    return out


def gather_params(params: Mapping[str, torch.Tensor], plan: Plan) -> Dict[str, torch.Tensor]:
    """The full tree from every model rank's shards, detached (a collective:
    every rank of the replica calls it); leaves outside the plan are the
    same storage as the given ones."""
    out = {}
    for n, t in params.items():
        t = t.detach()
        if n in plan:
            dim, parts = plan[n]
            t = t.contiguous()
            shards = [torch.empty_like(t) for _ in range(mesh.model_size())]
            dist.all_gather(shards, t, group=mesh.model_group())
            t = join_slices(shards, dim, parts)
        out[n] = t
    return out
