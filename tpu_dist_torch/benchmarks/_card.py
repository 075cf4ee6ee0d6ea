"""What the benchmark twins share: the device a row was measured on, and
the time of a call on it (CUDA events on a card, the host clock on the
CPU, where a row's numbers are no device metric)."""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

__all__ = ["device_stamp", "timed_seconds", "median_seconds"]


def device_stamp(device) -> dict:
    """The device a row was measured on: its name and, on a card, its name
    and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": str(device), "nvidia_smi": None}
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={index}"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    return {"device": torch.cuda.get_device_name(device), "nvidia_smi": smi}


def timed_seconds(fn, device) -> float:
    """Seconds of one ``fn()`` call on ``device``."""
    if torch.device(device).type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def median_seconds(fn, device, reps: int, warm: int = 0) -> float:
    """Median :func:`timed_seconds` of ``reps`` calls after ``warm``."""
    for _ in range(warm):
        fn()
    return statistics.median(timed_seconds(fn, device) for _ in range(reps))
