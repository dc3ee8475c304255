"""Median latency of the traced steps' gradient all-reduce, in ms: from the
host opening a ``train/allreduce`` span (around ``all_reduce_mean_`` in the
port's train step) to the device finishing the work queued by its close,
so the backward still queued when it opens counts too."""
from portbench.harness.spans import median_latency_ms


def read(r):
    return median_latency_ms("train/allreduce")
