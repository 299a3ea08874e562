"""The frame's readback: Engine.render's RGBA8 frame and ray count, from the
device to host memory.

On a CUDA device each goes by one DMA (`copy_(..., non_blocking=True)`) into
a pinned block drawn from PyTorch's caching host allocator
(`torch.empty(..., pin_memory=True)`), and one event waits for both. A
pageable `.cpu()` goes through CUDA's own staging buffer and a host copy
into a new array: on an H100 that took 0.7 to 10 ms for a 1080p frame,
the pinned copy 0.24 to 0.41 ms. The returned array keeps its pinned
tensor alive, so every frame is the caller's own and no later frame writes
into it; when the caller drops it, the block goes back to the pool for a
later frame. A caller that holds a few frames holds a few blocks.

On the CPU the frame tensor is already host memory, and its array shares
it (`.cpu().numpy()`, as the Engine always did).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class ReadbackStats:
    """Counts of one Engine's readbacks: `pinned`, the frames read back
    through pinned blocks; `new_blocks`, those of them for which the caching
    host allocator had to create a block rather than reuse a free one (None
    where the installed torch does not count the blocks it creates)."""

    pinned: int = 0
    new_blocks: Optional[int] = 0


def _host_blocks_made() -> Optional[int]:
    """Blocks the caching host allocator has created so far, or None."""
    stats = getattr(torch.cuda, "host_memory_stats_as_nested_dict", None)
    return None if stats is None else stats().get("num_host_alloc")


def read_back(rgba_t: torch.Tensor, rays_t: torch.Tensor,
              stats: Optional[ReadbackStats] = None) -> tuple[np.ndarray, int]:
    """(the frame as np.uint8 [H, W, 4], the ray count as an int) of the
    frame tensor `rgba_t` and the 0-d ray count `rays_t`, on one device.
    On a CUDA device this is the frame's one wait on the device (an event,
    after both copies); `stats`, if given, counts the readback."""
    if rgba_t.device.type != "cuda":
        return rgba_t.cpu().numpy(), int(rays_t.item())
    made = _host_blocks_made()
    rgba = torch.empty(rgba_t.shape, dtype=rgba_t.dtype, pin_memory=True)
    rays = torch.empty(rays_t.shape, dtype=rays_t.dtype, pin_memory=True)
    if stats is not None:
        stats.pinned += 1
        after = _host_blocks_made()
        if None in (made, after, stats.new_blocks):
            stats.new_blocks = None
        elif after > made:
            stats.new_blocks += 1
    rgba.copy_(rgba_t, non_blocking=True)
    rays.copy_(rays_t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(rgba_t.device))
    done.synchronize()
    return rgba.numpy(), int(rays.item())
