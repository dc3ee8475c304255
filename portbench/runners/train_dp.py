"""The data-parallel training runner: the ``train`` runner's step on
``ranks`` processes, one a card, the gradients averaged over NCCL (gloo on
the CPU) by the port's own step.

The run's process is rank 0; it spawns ranks 1 .. ranks - 1 and joins
them in one process group through ``parallel/mesh.py``
(``init_distributed`` with a ``tcp://127.0.0.1`` rendezvous, ``make_mesh``),
so each rank's step (``make_train_step``) all-reduces its gradients and
loss after the backward.  Every rank draws the same weights, the same pool
of global batches (``batch`` rows a rank, ``ranks`` x ``batch`` in all) and
the same global draws from the seed, and takes its rows of each
(``mesh.local_rows``, ``StepDraws.rows``).  Set-up and warm-up are the
``train`` runner's; rank 0 ends the window by the clock and tells the
others after each step over a gloo group of the host (no device sync).
``train_peak_mem_gib`` is the fullest rank's allocator peak over the
window.  A traced run traces rank 0 while the others run the same steps.

Correctness: rank 0's all-reduced loss, first clipped gradient and the
parameters' and EMA's change over the warm-up, against the float32
reference rerunning those steps over all the global rows (in blocks of
``reference_rows_per_block``), as the ``train`` runner compares one card.

A rank that fails ends the run at once with exit code 5 (the others would
wait in their next collective).
"""

from __future__ import annotations

import datetime
import gc
import os
import socket
import sys
import threading
import time

import torch

from portbench.harness import device as dev, seeds, trace as T
from portbench.harness.weights import make_weights
from portbench.reference.models import Arith
from portbench.runners import train as single

TIMEOUT = datetime.timedelta(minutes=10)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _global(traffic: dict) -> dict:
    """The mix with ``batch`` the global batch, for data, draws and the
    reference."""
    return dict(traffic, batch=traffic["batch"] * traffic["ranks"])


def _join(device, rank: int, ranks: int, init: str):
    """This process as ``rank`` of the group, on its card; the host group
    that carries the window's end."""
    import torch.distributed as dist

    from phendiff_tpu_torch.parallel import mesh

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(ranks), LOCAL_RANK=str(rank))
    device = mesh.init_distributed(device, init_method=init, timeout=TIMEOUT)
    mesh.make_mesh(1)
    return device, dist.new_group(backend="gloo", timeout=TIMEOUT)


def _steps(cell, fam, seed, seconds, trace, device, rank, ranks, init, setup_clock):
    """One rank's run; rank 0 returns what the result line needs."""
    import torch.distributed as dist

    from phendiff_tpu_torch.parallel import mesh

    device, host = _join(device, rank, ranks, init)
    cfg, traffic = cell.config, cell.traffic
    glob = _global(traffic)
    checked = traffic["checked_steps"]
    rows = mesh.local_rows(glob["batch"])
    weights = make_weights(fam.specs(cfg), seeds.derive(seed, "weights"), device)
    prog = fam.program_train(cfg, traffic, weights, device)
    del weights
    images, labels = single.host_batches(fam, cfg, glob, seed)
    images, labels = images[:, rows], labels[:, rows]
    state, names = prog.state, prog.names
    start = [state.params[k].detach().clone() for k in names]
    b1 = fam.train_config(traffic).optimizer.adam_beta1

    def one(k, spans=False):
        nonlocal state
        with T.span("train.step", spans):
            i = k % len(images)
            batch = (torch.from_numpy(images[i]).to(device, non_blocking=True),
                     torch.from_numpy(labels[i]).to(device, non_blocking=True))
            d = single.step_draws(fam, single.draws(fam, cfg, glob, seed, k, device))
            state, metrics = prog.step(state, batch, d.rows(rows))
        return metrics

    losses, grad = [], None
    for k in range(checked):
        losses.append(one(k)["loss"])
        if k == 0:
            grad = single._norms([state.opt_state.mu[x] for x in names]) / (1.0 - b1)
    change = single._norms(torch._foreach_sub([state.params[x].detach() for x in names], start))
    ema = single._norms(torch._foreach_sub([state.ema_params[x] for x in names], start))
    losses = [float(x) for x in losses]
    del start
    dev.sync(device)
    dist.barrier(group=host)
    setup_s = setup_clock()
    before = dev.peak_bytes(device)
    dev.reset_peak(device)

    nonfinite = torch.zeros((), dtype=torch.int64, device=device)
    flag = torch.ones(1, dtype=torch.int32)
    k = checked
    t0 = time.perf_counter()
    while True:
        nonfinite += one(k)["nonfinite"]
        k += 1
        flag[0] = int(time.perf_counter() - t0 < seconds)
        dist.broadcast(flag, 0, group=host)
        if not flag[0]:
            break
    dev.sync(device)
    window_s = time.perf_counter() - t0
    steps = k - checked
    peak = dev.peak_bytes(device)
    stretch = None
    if trace:
        def some_steps():
            for j in range(traffic["trace_steps"]):
                one(k + j, spans=rank == 0)
            return traffic["trace_steps"]

        if rank == 0:
            stretch = T.traced(some_steps)
        else:
            some_steps()
            dev.sync(device)
    peaks = [None] * ranks
    dist.all_gather_object(peaks, (peak, max(before, dev.peak_bytes(device)),
                                   int(nonfinite)), group=host)
    del prog, state
    gc.collect()
    dev.free(device)
    mesh.destroy()
    if rank:
        return None
    n = glob["batch"]
    out = {"setup_s": setup_s, "window_s": window_s, "attempted": steps * n,
           "failed": max(p[2] for p in peaks) * n,
           "end_to_end": {"train_peak_mem_gib": max(p[0] for p in peaks) / 2**30},
           "memory_peak_bytes": max(p[1] for p in peaks),
           "program": (names, losses, grad, change, ema)}
    if traffic.get("rate_metric"):
        out["end_to_end"][traffic["rate_metric"]] = steps * n / window_s
    if trace:
        out["stretch"] = stretch
        # rank 0's card: its rows' least times and its share of the FLOPs;
        # the rate is every rank's samples
        r = single.readings(fam, cfg, traffic, steps * traffic["batch"], window_s, stretch)
        r["samples"] = steps * n
        out["readings"] = r
    return out


def _rank_main(cell, seed, seconds, trace, device_type, rank, ranks, init):
    """A spawned rank (1 .. ranks - 1): its run, then exit 0."""
    _steps(cell, cell.family(), seed, seconds, trace, torch.device(device_type), rank, ranks,
           init, lambda: 0.0)


def _watch(procs, stop: threading.Event) -> None:
    """End the run at once when a spawned rank fails."""
    while not stop.wait(1.0):
        for p in procs:
            if p.exitcode not in (None, 0):
                print(f"portbench: rank process {p.name} failed with exit code {p.exitcode}",
                      file=sys.stderr, flush=True)
                os._exit(5)


def run(cell, fam, seed, seconds, trace, device, setup_clock):
    ranks = cell.traffic["ranks"]
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() < ranks:
        raise RuntimeError(f"{ranks} ranks need {ranks} cards, found {torch.cuda.device_count()}")
    init = f"tcp://127.0.0.1:{_free_port()}"
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}", daemon=True,
                         args=(cell, seed, seconds, trace, device.type, r, ranks, init))
             for r in range(1, ranks)]
    for p in procs:
        p.start()
    stop = threading.Event()
    watcher = threading.Thread(target=_watch, args=(procs, stop), daemon=True)
    watcher.start()
    try:
        out = _steps(cell, fam, seed, seconds, trace, device, 0, ranks, init, setup_clock)
    finally:
        stop.set()
        watcher.join()
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"rank exit codes {[p.exitcode for p in procs]}")
    names, losses, grad, change, ema = out.pop("program")
    glob = _global(cell.traffic)
    ref = single.reference_steps(fam, cell.config, glob, seed, Arith(), device)
    out["checked"] = single.compare([fam.reference_name(x) for x in names], losses, grad,
                                    change, ema, ref)
    return out
