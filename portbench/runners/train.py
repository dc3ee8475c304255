"""The training runner: the Trainer's step over uint8 batches.

Set-up draws the weights on the card, builds the port's train step and
state as the Trainer does (f32 master weights, compute in the traffic's
mixed precision, clip, AdamW, EMA), stages a pool of uint8 batches on the
host from the seed (as the Trainer's loader hands them) and drives that
same step and state through its first ``checked_steps`` steps (the
warm-up), each on its own batch.  The window then runs step after step,
each ending with its update and EMA, until ``seconds`` have passed, and
ends when the last step's work ends: the rate is the samples of all its
steps over all its seconds, an end-to-end metric under the mix's
``rate_metric`` where it names one, and handed to the per-layer readers
always.  ``train_peak_mem_gib`` is the allocator's peak over the window.
A traced run then runs ``trace_steps`` more steps under the profiler.

Correctness: after the window, with the program's state freed, the
float32 reference (``reference/``) runs the first ``checked_steps`` steps
from the same weights, batches and draws, in blocks of rows.  Numbers,
each the worst over the steps or over the trainable leaves:

* ``loss_gap``: |program's loss - reference's| / |reference's| of each step;
* ``grad_gap``: the norm of each leaf's first gradient as the optimizer
  got it (clipped; the program's from its first moment after one step,
  mu / (1 - b1)), against the reference's;
* ``change_gap`` and ``ema_gap``: the norm of each leaf's change of the
  parameters and of the EMA over the checked steps, against the
  reference's, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (AdamW moves those by rounding alone);

a gap of two norms over the larger of the reference leaf's norm and the
median leaf's.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.harness import device as dev, seeds, trace as T, work
from portbench.reference import diffusion as D
from portbench.harness.weights import make_weights
from portbench.reference.models import Arith
from portbench.runners.ddib import reference_models


def host_batches(fam, cfg, traffic, seed):
    """``pool_batches`` uint8 image batches [B, H, W, C] and balanced label
    batches on the host, drawn from the seed."""
    rng = np.random.default_rng(seeds.derive(seed, "data"))
    n, pool = traffic["batch"], traffic["pool_batches"]
    images = rng.integers(0, 256, (pool, n, *fam.image_shape(cfg)), dtype=np.uint8)
    labels = np.stack([(rng.permutation(n) < n // 2).astype(np.int64) for _ in range(pool)])
    return images, labels


def draws(fam, cfg, traffic, seed, step, device) -> dict:
    """Step ``step``'s random numbers: diffusion noise and the VAE
    posterior's noise (in the diffusion space's shape), timesteps, and the
    batch's CFG coin flip."""
    n = traffic["batch"]
    shape = (n, *fam.diffusion_shape(cfg))
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "draws", step))
    rng = np.random.default_rng(seeds.derive(seed, "timesteps", step))
    out = {"noise": torch.randn(shape, generator=gen, device=device),
           "enc_noise": torch.randn(shape, generator=gen, device=device),
           "timesteps": torch.from_numpy(rng.integers(
               0, cfg["scheduler"]["num_train_timesteps"], n)).to(device),
           "uncond": bool(rng.random() < traffic["proba_uncond"])}
    return out


def step_draws(fam, d):
    from phendiff_tpu_torch.train.train_loop import StepDraws

    return StepDraws(noise=d["noise"], timesteps=d["timesteps"], uncond=d["uncond"],
                     enc_noise=d["enc_noise"] if fam.HAS_VAE else None)


def _norms(tensors):
    return torch.stack(torch._foreach_norm([t.float() for t in tensors])).double().cpu().numpy()


def run(cell, fam, seed, seconds, trace, device, setup_clock):
    cfg, traffic = cell.config, cell.traffic
    checked, n = traffic["checked_steps"], traffic["batch"]
    weights = make_weights(fam.specs(cfg), seeds.derive(seed, "weights"), device)
    prog = fam.program_train(cfg, traffic, weights, device)
    del weights
    images, labels = host_batches(fam, cfg, traffic, seed)
    state = prog.state
    names = prog.names
    start = [state.params[k].detach().clone() for k in names]
    b1 = fam.train_config(traffic).optimizer.adam_beta1

    def one(k, spans=False):
        nonlocal state
        with T.span("train.step", spans):
            i = k % len(images)
            batch = (torch.from_numpy(images[i]).to(device, non_blocking=True),
                     torch.from_numpy(labels[i]).to(device, non_blocking=True))
            state, metrics = prog.step(state, batch,
                                       step_draws(fam, draws(fam, cfg, traffic, seed, k, device)))
        return metrics

    losses, grad = [], None
    for k in range(checked):
        losses.append(one(k)["loss"])
        if k == 0:
            grad = _norms([state.opt_state.mu[x] for x in names]) / (1.0 - b1)
    change = _norms(torch._foreach_sub([state.params[x].detach() for x in names], start))
    ema = _norms(torch._foreach_sub([state.ema_params[x] for x in names], start))
    losses = [float(x) for x in losses]
    del start
    dev.sync(device)
    setup_s = setup_clock()
    before = dev.peak_bytes(device)
    dev.reset_peak(device)

    nonfinite = torch.zeros((), dtype=torch.int64, device=device)
    k = checked
    t0 = time.perf_counter()
    while True:
        nonfinite += one(k)["nonfinite"]
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    dev.sync(device)
    window_s = time.perf_counter() - t0
    steps = k - checked
    peak = dev.peak_bytes(device)
    end_to_end = {"train_peak_mem_gib": peak / 2**30}
    if traffic.get("rate_metric"):
        end_to_end[traffic["rate_metric"]] = steps * n / window_s
    out = {"setup_s": setup_s, "window_s": window_s, "attempted": steps * n,
           "failed": int(nonfinite) * n, "end_to_end": end_to_end}
    if trace:
        def some_steps():
            for j in range(traffic["trace_steps"]):
                one(k + j, spans=True)
            return traffic["trace_steps"]

        out["stretch"] = T.traced(some_steps)
    out["memory_peak_bytes"] = max(before, dev.peak_bytes(device))
    del prog, state
    gc.collect()
    dev.free(device)
    if trace:
        out["readings"] = readings(fam, cfg, traffic, steps * n, window_s, out["stretch"])
    ref = reference_steps(fam, cfg, traffic, seed, Arith(), device)
    out["checked"] = compare([fam.reference_name(x) for x in names], losses, grad, change,
                             ema, ref)
    return out


def readings(fam, cfg, traffic, samples, window_s, stretch) -> dict:
    w = fam.work_train(cfg)
    n, steps = traffic["batch"], stretch.units
    size = 2 if traffic["mixed_precision"] in ("bf16", "fp16") else 4
    attn = n * steps * work.attention_least_s(w["attention"], size, True)
    gn = n * steps * work.group_norm_least_s(w["forward"], size, w["backward"])
    return {"window_s": window_s, "samples": samples, "flops": samples * w["step_flops"],
            "stretch": stretch,
            "attention_least_s": attn, "group_norm_least_s": gn}


def reference_steps(fam, cfg, traffic, seed, ar, device, rows=None) -> dict:
    """The reference's ``checked_steps`` steps, computed by ``ar``: each
    step's loss, the first clipped gradient's leaf norms, and the leaf
    norms of the parameters' and the EMA's change.  ``rows`` (a slice)
    trains on those rows of each batch alone, the loss their mean."""
    models = reference_models(fam, cfg, seed, device)
    params = fam.trainable(models)
    names = list(params)
    start = {k: p.detach().clone() for k, p in params.items()}
    ema = {k: p.detach().clone() for k, p in params.items()}
    opt = D.AdamW(start, lr=traffic["learning_rate"], max_norm=traffic["max_grad_norm"])
    sched = D.Schedule(cfg["scheduler"], device)
    images, labels = host_batches(fam, cfg, traffic, seed)
    block = traffic["reference_rows_per_block"]
    for p in params.values():
        p.requires_grad_(True)
    losses, grad = [], None
    for k in range(traffic["checked_steps"]):
        x = torch.from_numpy(images[k % len(images)]).to(device).float() / 127.5 - 1.0
        y = torch.from_numpy(labels[k % len(images)]).to(device)
        d = draws(fam, cfg, traffic, seed, k, device)
        sel = rows or slice(0, x.shape[0])
        count = len(range(*sel.indices(x.shape[0])))
        total = 0.0
        grads = {m: torch.zeros_like(p) for m, p in params.items()}
        for lo in range(sel.start, sel.stop, block):
            r = slice(lo, min(lo + block, sel.stop))
            part = {key: (v[r] if isinstance(v, torch.Tensor) else v) for key, v in d.items()}
            loss = fam.ref_train_loss(ar, models, sched, x[r], y[r], part, d["uncond"]) / count
            got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            for m, g in zip(names, got):
                if g is not None:
                    grads[m] += g
            total += float(loss.detach())
        losses.append(total)
        if k == 0:
            grad = D.leaf_norms(opt.clipped(grads).values())
        with torch.no_grad():
            opt.update({m: p.data for m, p in params.items()}, grads)
            D.ema_update(ema, {m: p.data for m, p in params.items()}, k + 1)
    with torch.no_grad():
        change = D.leaf_norms([params[m].data - start[m] for m in names])
        ema_change = D.leaf_norms([ema[m] - start[m] for m in names])
    return {"names": names, "losses": losses, "grad": grad, "change": change, "ema": ema_change}


def compare(names, losses, grad, change, ema, ref) -> dict:
    """The program's readings (its leaves under the reference's ``names``)
    against the reference's: the numbers that decide ``correct``."""
    order = [ref["names"].index(x) for x in names]
    if len(order) != len(ref["names"]):
        return {"trainable_leaves_missing": float(len(ref["names"]) - len(order))}
    want = {key: np.asarray(ref[key])[order] for key in ("grad", "change", "ema")}
    keep = want["grad"] >= 1e-3 * np.median(want["grad"])
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])),
        "grad_gap": D.worst_leaf_gap(grad, want["grad"])[0],
        "change_gap": D.worst_leaf_gap(change, want["change"], keep)[0],
        "ema_gap": D.worst_leaf_gap(ema, want["ema"], keep)[0],
    }
