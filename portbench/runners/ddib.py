"""The DDIB transfer runner: the comparison's class transfer of whole
batches back to back.

Set-up draws the weights on the card, builds the port's pipeline as the
comparison does (weights stored and computed in the traffic's dtype) and
warms every shape up with a two-step transfer of one batch.  The window
transfers batch after batch (images in [-1, 1] and balanced source labels
drawn from the seed for each batch, the target the other class) until
``seconds`` have passed, finishes the batch in flight and ends when it
ends: the rate (named by the mix's ``rate_metric``) is all the images of
the window over all its seconds.  A traced run then transfers one more
batch under the profiler.

Correctness: a random-weight UNet's 100-step trajectory is chaotic (a
one-ulp nudge of the input moves a 10-step f32 DDIB output by 0.07 on
[0, 1]), so the reference follows the program step by step.  In every
window batch the states of a few rows drawn from the seed are copied as
each denoiser call gets them, with the batch's output; after the window
the float32 reference (``reference/``) takes each state and makes the
next one, from the benchmark's own images, labels and weights.  Numbers:
``step_gap``, the worst over rows and steps of ||program's next state -
reference's|| / ||reference's step||; with a VAE also ``encode_gap`` (the
program's latents against the reference's encode of the images) and
``decode_gap`` (the program's images against the reference's decode of
the program's last latents), each a relative L2 error of a row.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.harness import device as dev, seeds, trace as T, work
from portbench.harness.weights import make_weights
from portbench.reference import diffusion as D
from portbench.reference.models import Arith

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def inputs(fam, cfg, traffic, seed, b, device):
    """Batch ``b``: images [B, H, W, C] f32 in [-1, 1], source labels with
    half of the batch in each class in an order drawn from the seed, and
    the target labels (the other class)."""
    n = traffic["batch"]
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "images", b))
    images = torch.rand((n, *fam.image_shape(cfg)), generator=gen, device=device) * 2 - 1
    order = np.random.default_rng(seeds.derive(seed, "labels", b)).permutation(n)
    src = torch.from_numpy((order < n // 2).astype(np.int64)).to(device)
    return images, src, 1 - src


def checked_rows(traffic, seed, b, device) -> torch.Tensor:
    rng = np.random.default_rng(seeds.derive(seed, "checked", b))
    rows = np.sort(rng.choice(traffic["batch"], traffic["checked_rows_per_batch"], replace=False))
    return torch.from_numpy(rows).to(device)


def transfer(prog, steps, images, src, tgt, rows=None, spans=False):
    """One batch through the port: (encode), ``transfer.ddib``, (decode).
    With ``rows`` the states of those rows as each denoiser call gets
    them, and their last state and output, are kept."""
    from phendiff_tpu_torch.pipelines.transfer import ddib

    states = []

    def denoiser(x, t, emb):
        if rows is not None:
            states.append(x.index_select(0, rows))
        with T.span("ddib.call", spans):
            return prog.denoiser(x, t, emb)

    with T.span("vae.encode", spans):
        x = prog.encode(images) if prog.encode is not None else images
    out = ddib(denoiser, prog.schedule, x, prog.embed(src), prog.embed(tgt),
               num_inference_steps=steps)
    final = out.index_select(0, rows) if rows is not None else None
    with T.span("vae.decode", spans):
        img = prog.decode(out) if prog.decode is not None else out
    kept = None if rows is None else (states, final, img.index_select(0, rows).float())
    return img, kept


def run(cell, fam, seed, seconds, trace, device, setup_clock):
    cfg, traffic = cell.config, cell.traffic
    steps = traffic["num_inference_steps"]
    dtype = DTYPES[traffic["compute_dtype"]]
    weights = make_weights(fam.specs(cfg), seeds.derive(seed, "weights"), device)
    prog = fam.program_transfer(cfg, weights, dtype, device)
    del weights
    images, src, tgt = inputs(fam, cfg, traffic, seed, -1, device)
    transfer(prog, 2, images, src, tgt)  # every shape of the window, warmed up
    dev.sync(device)
    setup_s = setup_clock()

    kept, bad = [], torch.zeros((), dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    while True:
        b = len(kept)
        images, src, tgt = inputs(fam, cfg, traffic, seed, b, device)
        img, rec = transfer(prog, steps, images, src, tgt,
                            rows=checked_rows(traffic, seed, b, device))
        bad += (~torch.isfinite(img.flatten(1)).all(1)).sum()
        kept.append(rec)
        del img
        if time.perf_counter() - t0 >= seconds:
            break
    dev.sync(device)
    window_s = time.perf_counter() - t0
    n_images = traffic["batch"] * len(kept)

    out = {"setup_s": setup_s, "window_s": window_s, "attempted": n_images,
           "failed": int(bad), "end_to_end": {traffic["rate_metric"]: n_images / window_s}}
    if trace:
        images, src, tgt = inputs(fam, cfg, traffic, seed, len(kept), device)

        def one_batch():
            transfer(prog, steps, images, src, tgt, spans=True)
            return 2 * steps  # denoiser calls

        out["stretch"] = T.traced(one_batch)
    out["memory_peak_bytes"] = dev.peak_bytes(device)
    del prog, images
    gc.collect()
    dev.free(device)
    if trace:
        out["readings"] = readings(fam, cfg, traffic, n_images, window_s, out["stretch"])
    out["checked"] = check(fam, cfg, traffic, seed, kept, device)
    return out


def readings(fam, cfg, traffic, n_images, window_s, stretch) -> dict:
    """What the per-layer readers read: the window's model FLOPs and the
    traced batch's least times for attention and GroupNorm."""
    steps = traffic["num_inference_steps"]
    w = fam.work_transfer(cfg)
    per_image = 2 * steps * w["denoiser"][0] + sum(w[k][0] for k in ("encode", "decode") if k in w)
    b = traffic["batch"]
    size = DTYPES[traffic["compute_dtype"]].itemsize
    calls = [(2 * steps, w["denoiser"][1])] + [(1, w[k][1]) for k in ("encode", "decode") if k in w]
    attn = b * sum(n * work.attention_least_s(c, size, False) for n, c in calls)
    gn = b * sum(n * work.group_norm_least_s(c, size) for n, c in calls)
    return {"window_s": window_s, "flops": n_images * per_image, "stretch": stretch,
            "attention_least_s": attn, "group_norm_least_s": gn}


def reference_models(fam, cfg, seed, device):
    """The reference's modules on the card, with the run's weights, float32
    and TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        models = fam.reference(cfg)
    weights = make_weights(fam.specs(cfg), seeds.derive(seed, "weights"), device)
    for part, module in models.items():
        module.to_empty(device=device)
        module.load_state_dict({n[len(part) + 1:]: w for n, w in weights.items()
                                if n.startswith(part + ".")})
        module.requires_grad_(False)
    return models


@torch.no_grad()
def check(fam, cfg, traffic, seed, kept, device) -> dict:
    """The numbers that decide ``correct``, from the kept rows of every
    window batch."""
    steps = traffic["num_inference_steps"]
    if any(len(states) != 2 * steps for states, _, _ in kept):
        return {"denoiser_calls_missing": 1.0}
    models = reference_models(fam, cfg, seed, device)
    images, src, tgt = [], [], []
    for b in range(len(kept)):
        rows = checked_rows(traffic, seed, b, device)
        x, s, t = inputs(fam, cfg, traffic, seed, b, device)
        images.append(x[rows])
        src.append(s[rows])
        tgt.append(t[rows])
    states = [torch.cat([k[0][i] for k in kept]).float() for i in range(2 * steps)]
    final = torch.cat([k[1] for k in kept]).float()
    decoded = torch.cat([k[2] for k in kept])
    return follow(fam, models, Arith(), cfg, steps, torch.cat(images), torch.cat(src),
                  torch.cat(tgt), states, final, decoded)


def follow(fam, models, ar, cfg, steps, images, src, tgt, states, final, decoded,
           per_step=None) -> dict:
    """The reference, computed by ``ar``, follows a trajectory (``states``:
    the input of each denoiser call; ``final``: the last state; ``decoded``:
    the output images) one step at a time; the worst gaps.  ``per_step``
    (a list) gets each step's worst gap."""
    sched = D.Schedule(cfg["scheduler"], images.device)
    numbers = {}
    if fam.HAS_VAE:
        numbers["encode_gap"] = float(D.relative(states[0], fam.ref_encode(ar, models, images)).max())
        x = states[0]
    else:
        x = images
    e_src, e_tgt = fam.ref_embed(models, src), fam.ref_embed(models, tgt)
    worst = 0.0
    rows = sched.ddib_rows(steps)
    for k, (te, tt, gen) in enumerate(rows):
        t = torch.full((x.shape[0],), max(te, 0), dtype=torch.long, device=x.device)
        out = fam.ref_denoise(ar, models, x, t, e_tgt if gen else e_src)
        want = D.ddib_step(sched, out, x, te, tt, gen)
        got = states[k + 1] if k + 1 < len(rows) else final
        step = (want - x).double().flatten(1).norm(dim=1).clamp_min(1e-30)
        gap = (got - want).double().flatten(1).norm(dim=1) / step
        worst = max(worst, float(gap.max()))
        if per_step is not None:
            per_step.append(gap.tolist())
        x = got
    numbers["step_gap"] = worst
    if fam.HAS_VAE:
        numbers["decode_gap"] = float(D.relative(decoded, fam.ref_decode(ar, models, final)).max())
    return numbers


@torch.no_grad()
def trajectory(fam, models, ar, cfg, steps, images, src, tgt):
    """A trajectory of the reference itself, computed by ``ar`` (the
    control puts the reference in fp8 in the program's place)."""
    sched = D.Schedule(cfg["scheduler"], images.device)
    x = fam.ref_encode(ar, models, images) if fam.HAS_VAE else images
    e_src, e_tgt = fam.ref_embed(models, src), fam.ref_embed(models, tgt)
    states = []
    for te, tt, gen in sched.ddib_rows(steps):
        states.append(x)
        t = torch.full((x.shape[0],), max(te, 0), dtype=torch.long, device=x.device)
        x = D.ddib_step(sched, fam.ref_denoise(ar, models, x, t, e_tgt if gen else e_src),
                        x, te, tt, gen)
    decoded = fam.ref_decode(ar, models, x) if fam.HAS_VAE else x
    return states, x, decoded
