"""Device-memory introspection — counterpart of ``tpu_dist/utils/memory.py``.

The JAX package wraps the per-device allocator statistics XLA publishes
under ``torch.cuda``'s names; the port reads ``torch.cuda``'s caching
allocator itself and publishes it under XLA's key names
(``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``,
``largest_alloc_size``), so callers of either package read the same keys.
Everything is in bytes and defaults to the current CUDA device; with no
CUDA device and no ``device`` named, the functions raise rather than read
the CPU.

A CPU device publishes no allocator statistics: it returns ``{}``, 0 and
``(0, 0)``, as the JAX package's CPU platform does.  A CUDA device always
returns its real statistics, never zeros in their place.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops._build import resolve_device

__all__ = ["memory_stats", "memory_allocated", "max_memory_allocated",
           "mem_get_info", "memory_summary"]

def _largest_live_block(device: torch.device) -> int:
    """Bytes of the largest allocation live on ``device``: the caching
    allocator keeps no history of its largest request, so this reads the
    blocks allocated now."""
    largest = 0
    for seg in torch.cuda.memory_snapshot():
        if seg.get("device") != device.index:
            continue
        for block in seg.get("blocks", ()):
            if block.get("state") == "active_allocated":
                largest = max(largest, int(block.get("size", 0)))
    return largest


def memory_stats(device=None) -> Dict[str, int]:
    """Allocator statistics for ``device`` (default: the current CUDA
    device) under XLA's key names: ``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_limit`` (the card's memory) and
    ``largest_alloc_size`` (the largest live allocation) — an empty dict
    on the CPU.  torch analogue: ``torch.cuda.memory_stats``."""
    d = resolve_device(device)
    if d.type != "cuda":
        return {}
    if d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return {"bytes_in_use": torch.cuda.memory_allocated(d),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(d),
            "bytes_limit": torch.cuda.mem_get_info(d)[1],
            "largest_alloc_size": _largest_live_block(d)}


def memory_allocated(device=None) -> int:
    """Bytes currently held by live tensors on ``device`` (0 on the CPU).
    torch analogue: ``torch.cuda.memory_allocated``."""
    return int(memory_stats(device).get("bytes_in_use", 0))


def max_memory_allocated(device=None) -> int:
    """High-water mark of ``memory_allocated`` since the process started
    or since ``torch.cuda.reset_peak_memory_stats``.  torch analogue:
    ``torch.cuda.max_memory_allocated``."""
    return int(memory_stats(device).get("peak_bytes_in_use", 0))


def mem_get_info(device=None) -> Tuple[int, int]:
    """``(free_bytes, total_bytes)`` of ``device`` as the driver reports
    them — torch analogue: ``torch.cuda.mem_get_info``.  ``(0, 0)`` on the
    CPU."""
    d = resolve_device(device)
    if d.type != "cuda":
        return 0, 0
    free, total = torch.cuda.mem_get_info(d)
    return int(free), int(total)


def memory_summary(device=None) -> str:
    """Human-readable snapshot (torch.cuda.memory_summary analogue)."""
    d = resolve_device(device)
    stats = memory_stats(d)
    if not stats:
        return f"{d}: no allocator statistics published on this platform"
    gib = 1 << 30
    return "\n".join([f"{d} memory summary:"] + [
        f"  {key:<22} {value / gib:8.3f} GiB" for key, value in stats.items()])
