"""Image-to-image class transfer: DDIB and the inverted-regeneration probe.

Counterpart of ``ddib`` and ``inverted_regeneration`` in
``phendiff_tpu/pipelines/transfer.py``.  With eta = 0 the DDIM generation
update and the inversion update are the same map,
    x' = sqrt(a[t_tgt]) x0 + sqrt(1 - a[t_tgt]) eps,   (x0, eps) at t_eval,
so the bridge is one host loop over 2N (t_eval, t_target, is_generation)
rows: the inversion rows under the source embedding, then the generation
rows under the target embedding.  Two details hold as in the JAX package:
the network's time is clamped to >= 0 while t_eval = -1 keeps its
final-alpha lookup, and x0-clipping applies on the generation rows only.
"""

from __future__ import annotations

import numpy as np
import torch

from phendiff_tpu_torch.core import scheduler as S
from phendiff_tpu_torch.pipelines.conditional_ddim import DenoiserFn


def ddib_rows(config: S.SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """[2N, 3] int64 rows (t_eval, t_target, is_generation)."""
    inv_t, inv_next = S.inversion_timestep_pairs(config, num_inference_steps)
    gen_t, gen_prev = S.timestep_pairs(config, num_inference_steps)
    return np.stack([
        np.concatenate([inv_t, gen_t]),
        np.concatenate([inv_next, gen_prev]),
        np.concatenate([np.zeros(len(inv_t)), np.ones(len(gen_t))]),
    ], axis=1).astype(np.int64)


@torch.no_grad()
def ddib(
    denoiser: DenoiserFn,
    schedule: S.NoiseSchedule,
    images: torch.Tensor,
    source_emb: torch.Tensor,
    target_emb: torch.Tensor,
    *,
    num_inference_steps: int = 100,
) -> torch.Tensor:
    """Dual diffusion implicit bridge: x --invert(source)--> z --gen(target)--> x'."""
    x = images.to(schedule.device, torch.float32)
    b = x.shape[0]
    for te, tt, is_gen in ddib_rows(schedule.config, num_inference_steps).tolist():
        emb = target_emb if is_gen else source_emb
        t_net = torch.full((b,), max(te, 0), dtype=torch.int64, device=x.device)
        model_out = denoiser(x, t_net, emb)
        x0, eps = S.predict_x0_eps(schedule, model_out, te, x)
        if is_gen:
            x0 = S._maybe_clip_x0(schedule, x0)
        a_tgt = S._gather_alpha(schedule, tt).to(x.dtype)
        x = torch.sqrt(a_tgt) * x0 + torch.sqrt(1.0 - a_tgt) * eps
    return x


def inverted_regeneration(
    denoiser: DenoiserFn,
    schedule: S.NoiseSchedule,
    images: torch.Tensor,
    source_emb: torch.Tensor,
    *,
    num_inference_steps: int = 100,
) -> torch.Tensor:
    """Identity round trip (reconstruction-error probe)."""
    return ddib(denoiser, schedule, images, source_emb, source_emb,
                num_inference_steps=num_inference_steps)
