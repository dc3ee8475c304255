"""The SD UNet as a chain of stages over one copy of its weights.

Counterpart of ``phendiff_tpu/models/sd_segmented.py``.  The stages are
``stem`` (time embedding, ``conv_in``), ``down:i`` (one level's resnets,
cross-attention blocks and downsample), ``mid``, ``up:i`` (one level's
resnets over the concatenated skips, attention blocks, upsample) and
``out`` (GroupNorm+SiLU, ``conv_out``).  Each stage is a small module that
holds the ``SDUNet``'s own submodules under their own names, so a stage's
parameter names are the monolith's (``down_0_res_0.conv1.weight``,
``norm_out_scale``, ...) and ``torch.func.functional_call`` runs it on any
flat dict of those names (the trainer's f32 master weights).

Why the stages exist here: the JAX package wrote them because its compile
transport rejected the 866 M-parameter program.  Eager PyTorch has no such
limit; the stages serve what they make possible:

* ``forward_with_input_vjp``: the guided transfer's input gradient with at
  most one stage's autograd graph alive (each stage is re-run with its
  activation inputs requiring grad, and ``torch.autograd.grad`` runs on
  them only: parameters get no gradient);
* ``train/segmented_train.py``: the fine-tune's backward as a chain of
  per-stage VJPs (``vjp`` with ``param_grads``), the optimizer applied one
  stage at a time;
* ``parallel/pp.py``: the stages placed on several cards.

``__call__`` runs the same ops in the same order as ``SDUNet.forward``, so
its output equals the monolith's bit for bit on one device.  There is no
separate init: build the ``SDUNet`` and call its ``init_weights(generator)``
(the JAX stage-by-stage init reproduces the monolith's, so the trees agree
by construction).  ``cost_flops`` counts matrix products and convolutions
(``torch.utils.flop_counter``), not XLA's elementwise FLOPs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.func import functional_call

from phendiff_tpu_torch.models.embeddings import sinusoidal_timestep_embedding
from phendiff_tpu_torch.models.sd_unet import SDUNet, SDUNetConfig
from phendiff_tpu_torch.ops.group_norm import group_norm

Params = Mapping[str, torch.Tensor]


def stage_keys(cfg: SDUNetConfig) -> List[str]:
    """Topological stage order: stem, down:0..n-1, mid, up:0..n-1, out."""
    n = len(cfg.block_out_channels)
    return (["stem"] + [f"down:{i}" for i in range(n)] + ["mid"]
            + [f"up:{i}" for i in range(n)] + ["out"])


def stage_names(cfg: SDUNetConfig, key: str) -> List[str]:
    """The monolith's top-level module (or parameter) names a stage owns;
    those a level lacks (no attention in a plain block, no downsample at the
    last level) are listed all the same, as the JAX package lists them."""
    L = cfg.layers_per_block
    if key == "stem":
        return ["time_embedding", "conv_in"]
    if key == "mid":
        return ["mid_res_0", "mid_attn", "mid_res_1"]
    if key == "out":
        return ["norm_out_scale", "norm_out_bias", "conv_out"]
    kind, i = key.split(":")
    i = int(i)
    if kind == "down":
        return ([f"down_{i}_res_{j}" for j in range(L)]
                + [f"down_{i}_attn_{j}" for j in range(L)] + [f"down_{i}_downsample"])
    return ([f"up_{i}_res_{j}" for j in range(L + 1)]
            + [f"up_{i}_attn_{j}" for j in range(L + 1)] + [f"up_{i}_upsample"])


class _Stage(nn.Module):
    """A stage: the ``SDUNet``'s submodules (and root parameters) that
    ``stage_names`` lists, shared with it under the same names."""

    def __init__(self, unet: SDUNet, key: str):
        super().__init__()
        self.cfg, self.dtype = unet.config, unet.dtype
        for name in stage_names(unet.config, key):
            part = getattr(unet, name, None)
            if isinstance(part, nn.Parameter):
                self.register_parameter(name, part)
            elif part is not None:
                self.add_module(name, part)


class _Stem(_Stage):
    def forward(self, sample, timesteps):
        cfg, dt = self.cfg, self.dtype
        x = sample.to(dt)
        timesteps = torch.as_tensor(timesteps, device=x.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(x.shape[0])
        temb = sinusoidal_timestep_embedding(
            timesteps, cfg.block_out_channels[0],
            flip_sin_to_cos=cfg.flip_sin_to_cos, freq_shift=cfg.freq_shift,
        )
        temb = self.time_embedding(temb.to(dt))
        return self.conv_in(x), temb


class _DownStage(_Stage):
    def __init__(self, unet: SDUNet, level: int):
        super().__init__(unet, f"down:{level}")
        self.level = level

    def forward(self, x, temb, ctx):
        cfg, i = self.cfg, self.level
        outs = []
        for j in range(cfg.layers_per_block):
            x = getattr(self, f"down_{i}_res_{j}")(x, temb)
            if cfg.down_block_types[i] == "CrossAttnDownBlock2D":
                x = getattr(self, f"down_{i}_attn_{j}")(x, ctx)
            outs.append(x)
        if i < len(cfg.block_out_channels) - 1:
            x = getattr(self, f"down_{i}_downsample")(x)
            outs.append(x)
        return x, outs


class _Mid(_Stage):
    def forward(self, x, temb, ctx):
        x = self.mid_res_0(x, temb)
        x = self.mid_attn(x, ctx)
        return self.mid_res_1(x, temb)


class _UpStage(_Stage):
    def __init__(self, unet: SDUNet, level: int):
        super().__init__(unet, f"up:{level}")
        self.level = level

    def forward(self, x, temb, ctx, skips: Sequence[torch.Tensor]):
        cfg, i, dt = self.cfg, self.level, self.dtype
        for j in range(cfg.layers_per_block + 1):
            x = torch.cat([x, skips[j].to(dt)], dim=-1)
            x = getattr(self, f"up_{i}_res_{j}")(x, temb)
            if cfg.up_block_types[i] == "CrossAttnUpBlock2D":
                x = getattr(self, f"up_{i}_attn_{j}")(x, ctx)
        if i < len(cfg.up_block_types) - 1:
            x = getattr(self, f"up_{i}_upsample")(x)
        return x


class _Out(_Stage):
    def forward(self, x):
        cfg = self.cfg
        x = group_norm(x, num_groups=cfg.norm_num_groups, eps=cfg.norm_eps,
                       scale=self.norm_out_scale, bias=self.norm_out_bias, act="silu",
                       out_dtype=self.dtype)
        return self.conv_out(x)


def _flat(tree) -> List[Optional[torch.Tensor]]:
    """The tensors of a nest of tuples and lists, in order."""
    if isinstance(tree, (tuple, list)):
        return [t for part in tree for t in _flat(part)]
    return [tree]


def _unflat(tree, leaves: List) -> Any:
    """``tree``'s structure over ``leaves`` (consumed from the front)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflat(part, leaves) for part in tree)
    return leaves.pop(0)


def _with_grad(tree):
    """Detached copies requiring grad of a nest's floating tensors."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_with_grad(part) for part in tree)
    return tree.detach().requires_grad_()


class SegmentedSDUNet:
    """``SDUNet.forward`` as a chain of stage calls over ``unet``'s weights
    (or over a flat dict of them, ``params=``)."""

    def __init__(self, unet: SDUNet):
        if unet.tp_conv_in is not None:
            raise ValueError("the segmented SD route runs whole (unsharded) UNets")
        self.unet, self.cfg, self.dtype = unet, unet.config, unet.dtype
        self.keys = stage_keys(self.cfg)
        n = len(self.cfg.block_out_channels)
        self.stages: Dict[str, nn.Module] = {
            "stem": _Stem(unet, "stem"), "mid": _Mid(unet, "mid"), "out": _Out(unet, "out"),
            **{f"down:{i}": _DownStage(unet, i) for i in range(n)},
            **{f"up:{i}": _UpStage(unet, i) for i in range(n)},
        }
        self._param_names = {k: [n for n, _ in m.named_parameters()]
                             for k, m in self.stages.items()}

    def names(self, key: str) -> List[str]:
        """The JAX package's ``_names(key)``."""
        return stage_names(self.cfg, key)

    def param_names(self, key: str) -> List[str]:
        """The flat parameter names of stage ``key`` (the monolith's)."""
        return self._param_names[key]

    def stage_params(self, key: str, params: Params) -> Dict[str, torch.Tensor]:
        """Stage ``key``'s entries of ``params``; a missing one raises."""
        names = self._param_names[key]
        missing = [n for n in names if n not in params]
        if missing:
            raise KeyError(f"stage {key}: {len(missing)} parameters missing, "
                           f"e.g. {missing[:3]}")
        return {n: params[n] for n in names}

    def run(self, key: str, *args, params: Optional[Params] = None):
        """Stage ``key`` on ``args``, on the module's weights or ``params``."""
        stage = self.stages[key]
        if params is None:
            return stage(*args)
        return functional_call(stage, self.stage_params(key, params), args)

    def vjp(self, key: str, args: tuple, cts, *, wrt: Sequence[int] = (),
            params: Optional[Params] = None, param_grads: bool = False):
        """Re-run stage ``key`` on ``args`` with ``args[i]`` (i in ``wrt``,
        tensors or tuples of them) and, with ``param_grads``, its parameters
        requiring grad, and pull the output cotangents ``cts`` (the output's
        structure; None where an output gets none) back through it with one
        ``torch.autograd.grad``.  Returns ``(param_grads, arg_grads)``: a
        dict (zeros where a parameter is unused; empty without
        ``param_grads``) and ``args``' grads for ``wrt`` in their structure
        (None where an input is unused).  The graph dies on return."""
        with torch.enable_grad():
            args = list(args)
            for i in wrt:
                args[i] = _with_grad(args[i])
            p = None
            if params is not None or param_grads:
                p = self.stage_params(key, params if params is not None
                                      else dict(self.stages[key].named_parameters()))
                if param_grads:
                    p = {n: t.detach().requires_grad_() for n, t in p.items()}
            out = self.run(key, *args, params=p)
            outs, grads_out = [], []
            for o, c in zip(_flat(out), _flat(cts)):
                if c is not None and o.requires_grad:
                    outs.append(o)
                    grads_out.append(c)
            leaves = [t for i in wrt for t in _flat(args[i])]
            plist = list(p.values()) if param_grads else []
            got = list(torch.autograd.grad(outs, leaves + plist, grads_out, allow_unused=True))
        gp = {}
        if param_grads:
            for (n, t), g in zip(p.items(), got[len(leaves):]):
                gp[n] = torch.zeros_like(t) if g is None else g
        got = got[:len(leaves)]
        return gp, [_unflat(args[i], got) for i in wrt]

    # -- forward -------------------------------------------------------------
    def _forward(self, sample, timesteps, encoder_hidden_states, params,
                 record: Optional[dict] = None, move: Callable = None):
        """The chain; with ``record`` each stage's inputs land there (and
        the skips each down stage pushed, under ``"down_out_count"``);
        ``move(key, *tensors)`` brings a stage's inputs to its device."""
        L = self.cfg.layers_per_block
        move = move or (lambda key, *ts: ts)
        ctx = encoder_hidden_states.to(self.dtype)
        stem_args = move("stem", sample, torch.as_tensor(timesteps, device=sample.device))
        x, temb = self.run("stem", *stem_args, params=params)
        skips = [x]
        count = {}
        for key in self.keys[1:]:
            kind = key.split(":")[0]
            if kind == "down":
                args = move(key, x, temb, ctx)
                x, outs = self.run(key, *args, params=params)
                skips.extend(outs)
                count[key] = len(outs)
            elif kind == "mid":
                args = move(key, x, temb, ctx)
                x = self.run(key, *args, params=params)
            elif kind == "up":
                cons = move(key, *(skips.pop() for _ in range(L + 1)))
                args = (*move(key, x, temb, ctx), tuple(cons))
                x = self.run(key, *args, params=params)
            else:
                args = move(key, x)
                x = self.run(key, *args, params=params)
            if record is not None:
                record[key] = args
        assert not skips
        if record is not None:
            record["stem"] = stem_args
            record["down_out_count"] = count
        return x

    def __call__(self, sample: torch.Tensor, timesteps, encoder_hidden_states: torch.Tensor,
                 params: Optional[Params] = None) -> torch.Tensor:
        return self._forward(sample, timesteps, encoder_hidden_states, params).to(sample.dtype)

    def forward_with_input_vjp(self, sample: torch.Tensor, timesteps,
                               encoder_hidden_states: torch.Tensor,
                               params: Optional[Params] = None, move: Optional[Callable] = None
                               ) -> Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
        """``(pred, vjp_fn)``, ``vjp_fn(ct_pred) -> d sample``: the forward
        under ``no_grad`` recording each stage's inputs, and a walk
        out -> up* -> mid -> down* -> stem that re-runs one stage at a time
        with its activation inputs requiring grad (the temb and context
        inputs do not depend on the latent: their cotangents are never
        formed), with the training chain's skip routing.  ``move(key,
        *tensors)`` brings tensors to stage ``key``'s device (pipeline
        placement); both outputs are where the last stage put them."""
        args_of: dict = {}
        with torch.no_grad():
            pred = self._forward(sample, timesteps, encoder_hidden_states, params, args_of,
                                 move)
        count = args_of.pop("down_out_count")
        return pred.to(sample.dtype), lambda ct: input_vjp(self, args_of, count, pred.dtype,
                                                           ct, params, move)

    # -- cost ------------------------------------------------------------------
    def cost_flops(self, sample: torch.Tensor, timesteps,
                   encoder_hidden_states: torch.Tensor) -> float:
        """FLOPs of one forward at these inputs' shapes: the sum over the
        stages of ``torch.utils.flop_counter.FlopCounterMode``, run on the
        meta device (matrix products and convolutions only)."""
        from torch.utils.flop_counter import FlopCounterMode

        from phendiff_tpu_torch.ops.routes import plain_kernels

        with torch.device("meta"):
            meta = SegmentedSDUNet(SDUNet(self.cfg, dtype=self.dtype))
        total = 0

        def counted(key, *args, params=None):
            nonlocal total
            with FlopCounterMode(display=False) as counter:
                out = SegmentedSDUNet.run(meta, key, *args)
            total += counter.get_total_flops()
            return out

        meta.run = counted
        to_meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
        with plain_kernels(), torch.no_grad():
            meta._forward(to_meta(sample), to_meta(torch.as_tensor(timesteps)),
                          to_meta(encoder_hidden_states), None)
        return float(total)


def input_vjp(seg: SegmentedSDUNet, args_of: dict, down_out_count: Dict[str, int],
              pred_dtype: torch.dtype, ct_pred: torch.Tensor,
              params: Optional[Params] = None, move: Optional[Callable] = None
              ) -> torch.Tensor:
    """The latent cotangent of a recorded forward (``args_of``: each stage's
    inputs, ``down_out_count``: the skips each down stage pushed): the
    per-stage input VJPs out -> up* -> mid -> down* -> stem.  ``move(key,
    *tensors)`` brings cotangents to stage ``key``'s device (pipeline
    placement)."""
    move = move or (lambda key, *ts: ts)
    n = len(seg.cfg.block_out_channels)
    (ct,) = move("out", ct_pred.to(pred_dtype))
    _, (ct_x,) = seg.vjp("out", args_of["out"], ct, wrt=(0,), params=params)
    skip_cts: List[torch.Tensor] = []
    for i in reversed(range(n)):
        key = f"up:{i}"
        _, (ct_x, d_skips) = seg.vjp(key, args_of[key], *move(key, ct_x), wrt=(0, 3),
                                     params=params)
        # the skips were popped off the stack top: reversed, they are in
        # stack order, and walking the up stages last to first rebuilds the
        # stack bottom to top
        skip_cts = skip_cts + list(reversed(d_skips))
    _, (ct_x,) = seg.vjp("mid", args_of["mid"], *move("mid", ct_x), wrt=(0,), params=params)
    for i in reversed(range(n)):
        key = f"down:{i}"
        cnt = down_out_count[key]
        ct_x, *outs_ct = move(key, ct_x, *skip_cts[-cnt:])
        skip_cts = skip_cts[:-cnt]
        _, (ct_x,) = seg.vjp(key, args_of[key], (ct_x, outs_ct), wrt=(0,), params=params)
    (stem_skip_ct,) = skip_cts
    ct_x, stem_skip_ct = move("stem", ct_x, stem_skip_ct)
    _, (d_sample,) = seg.vjp("stem", args_of["stem"], (ct_x + stem_skip_ct, None), wrt=(0,),
                             params=params)
    return d_sample.to(ct_pred.dtype)
