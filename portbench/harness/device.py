"""Waits and memory readings of the device a run uses; on the CPU (the
harness's own tests) they do nothing and read 0."""

from __future__ import annotations

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
