"""Adam's update of the full-width SD-2.1 fine-tune on the card: the update
over chunks of the tensor list against one chunk of the whole list, with
f32 and with bf16 first moments, alone and inside the train step.

Four arms: the first moment in f32 or bf16, times ``train_loop.UPDATE_CHUNK``
as shipped ("chunked") or larger than the list ("whole").  Every part runs
its arms in rounds, in the order a, b, c, d, then d, c, b, a, and so on.

- ``update``: ``Optimizer.update`` on the trainable parameters of
  ``obs.forward_profile.sd_train_step`` (865,910,724 + the class embedding,
  f32) with random gradients from ``--seed``, ``REPS`` updates an arm a
  round: host ms (until the call returns, nothing waited for), wall ms
  (synchronised before and after), the peak over what was allocated
  before the call (GiB), and device ms from a profiler trace of 2
  updates.
- ``step``: that train step (128 px, batch 32, no remat, the frozen bf16
  VAE's encode, ``chip_smoke.py``'s sd_train_path), one untimed step an
  arm a round, then ``--steps`` timed ones: host ms and ms a step per
  round, the median, the peak over what was allocated before the arm
  (both arms' states stay resident, so only differences between arms
  mean anything), and a trace of 2 steps (device ms, idle share, the
  ``optimizer`` category).

Prints one JSON line a part, then the ``nvidia-smi`` name and power limit.

    python -m phendiff_tpu_torch.tools.bench_adam_update [--rounds 4 --steps 4]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import time

import torch

from phendiff_tpu_torch.train import train_loop

CHUNKED = train_loop.UPDATE_CHUNK
WHOLE = 1 << 62
ARMS = (("float32", "chunked"), ("float32", "whole"),
        ("bfloat16", "chunked"), ("bfloat16", "whole"))
BATCH, RES = 32, 128
REPS = 5  # timed updates an arm a round


@contextlib.contextmanager
def chunking(kind: str):
    train_loop.UPDATE_CHUNK = CHUNKED if kind == "chunked" else WHOLE
    try:
        yield
    finally:
        train_loop.UPDATE_CHUNK = CHUNKED


def round_order(r: int):
    return ARMS if r % 2 == 0 else ARMS[::-1]


def arm_name(dtype: str, kind: str) -> str:
    return f"{dtype}_{kind}"


def gib(n_bytes: int) -> float:
    return n_bytes / 2**30


def summary(xs) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs), "all": xs}


def update_part(pipe, seed: int, rounds: int) -> dict:
    from phendiff_tpu_torch.obs.forward_profile import sd_train_step, trace

    arms = {}
    for dtype in ("float32", "bfloat16"):
        _, state, _, opt = sd_train_step(pipe, False, moment_dtype=dtype)
        arms[dtype] = (opt, state)
    params = arms["float32"][1].params
    gen = torch.Generator(device="cuda").manual_seed(seed)
    grads = {n: torch.randn(p.shape, generator=gen, device="cuda").mul_(1e-3)
             for n, p in params.items()}
    host = {arm_name(*a): [] for a in ARMS}
    wall = {arm_name(*a): [] for a in ARMS}
    peak = dict.fromkeys(host, 0.0)
    for r in range(rounds):
        for dtype, kind in round_order(r):
            opt, state = arms[dtype]
            name = arm_name(dtype, kind)
            with chunking(kind):
                opt.update(grads, state.opt_state, state.params)  # the allocator's first fill
                for _ in range(REPS):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    before = torch.cuda.memory_allocated()
                    t0 = time.perf_counter()
                    opt.update(grads, state.opt_state, state.params)
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    host[name].append(1e3 * (t1 - t0))
                    wall[name].append(1e3 * (t2 - t0))
                    peak[name] = max(peak[name],
                                     gib(torch.cuda.max_memory_allocated() - before))
    out = {"part": "update", "tensors": len(params),
           "elements": sum(p.numel() for p in params.values()),
           "chunk_elements": CHUNKED, "rounds": rounds, "reps": REPS, "arms": {}}
    for dtype, kind in ARMS:
        opt, state = arms[dtype]
        name = arm_name(dtype, kind)
        with chunking(kind):
            traced = trace(lambda: opt.update(grads, state.opt_state, state.params), 2)
        out["arms"][name] = {"host_ms": summary(host[name]), "wall_ms": summary(wall[name]),
                             "peak_over_resident_gib": peak[name],
                             "traced_device_ms": traced["device_ms_per_call"],
                             "traced_wall_ms": traced["wall_ms_per_call"],
                             "traced_launches": traced["launches_per_call"]}
    return out


def step_part(pipe, seed: int, rounds: int, steps: int) -> dict:
    from phendiff_tpu_torch.obs.forward_profile import sd_train_step, trace
    from phendiff_tpu_torch.train.train_loop import make_draws

    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    images = torch.rand(BATCH, RES, RES, 3, generator=gen, device="cuda") * 2 - 1
    labels = torch.tensor([0, 1], device="cuda").repeat(BATCH // 2)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        step, state, kw, _ = sd_train_step(pipe, False, moment_dtype=dtype)
        runs[dtype] = [step, state, kw["diffusion_shape"]((BATCH, RES, RES, 3))]

    def one(dtype):
        step, state, shape = runs[dtype]
        draws = make_draws(seed, state.step, shape, pipe.schedule.num_train_timesteps, 0.1,
                           "cuda", posterior=True)
        runs[dtype][1], _ = step(state, (images, labels), draws)

    ms = {arm_name(*a): [] for a in ARMS}
    host = {arm_name(*a): [] for a in ARMS}
    peak = dict.fromkeys(ms, 0.0)
    for r in range(rounds):
        for dtype, kind in round_order(r):
            name = arm_name(dtype, kind)
            with chunking(kind):
                one(dtype)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                for _ in range(steps):
                    one(dtype)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
            host[name].append(1e3 * (t1 - t0) / steps)
            ms[name].append(1e3 * (t2 - t0) / steps)
            peak[name] = max(peak[name], gib(torch.cuda.max_memory_allocated() - before))
    out = {"part": "step", "batch": BATCH, "res": RES, "rounds": rounds, "steps": steps,
           "arms": {}}
    for dtype, kind in ARMS:
        name = arm_name(dtype, kind)
        with chunking(kind):
            traced = trace(lambda: one(dtype), 2)
        out["arms"][name] = {
            "ms_per_step": summary(ms[name]), "host_ms_per_step": summary(host[name]),
            "peak_over_resident_gib": peak[name],
            "traced_wall_ms": traced["wall_ms_per_call"],
            "traced_device_ms": traced["device_ms_per_call"],
            "device_idle_share": traced["device_idle_share"],
            "traced_optimizer_ms": traced["ms_per_call_by_category"].get("optimizer"),
            "mu_dtype": str(next(iter(runs[dtype][1].opt_state.mu.values())).dtype)}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    from phendiff_tpu_torch.obs.forward_profile import sd_pipeline

    pipe = sd_pipeline(torch.bfloat16, args.seed, cast=False)
    for part in (lambda: update_part(pipe, args.seed, args.rounds),
                 lambda: step_part(pipe, args.seed, args.rounds, args.steps)):
        rec = part()
        rec["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
