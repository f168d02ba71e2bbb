"""Device time of a callable on the current CUDA stream, from CUDA events."""

from __future__ import annotations

import torch


def device_ms(fn, reps: int, hold: bool = True) -> float:
    """Mean device time in ms of ``fn()`` over ``reps`` back-to-back runs
    after one warm-up run.  With ``hold``, a spin kernel holds the stream
    while the host queues the runs, so the events see them back to back,
    without the host's launch overhead (as long as the host keeps ahead of
    the card).  Without it the events also see the host's gaps, which is
    what a caller wants for a function that synchronises inside."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
