"""Device time of a callable on the current CUDA stream, from CUDA events;
and the host calls by which torch.profiler counts device operations."""

from __future__ import annotations

import torch

# The host's calls that each queue one operation on the card (a kernel, a
# copy or a fill), as torch.profiler names CUPTI's runtime and driver API
# records.  A profile counts device operations by these: CUPTI may drop
# device records at the start of a trace, never these
# (``python3 -m vrt_torch.apps.probe_profiler``).
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpy", "cudaMemcpyAsync",
                "cudaMemcpy2DAsync", "cudaMemset", "cudaMemsetAsync",
                "cuMemcpyAsync", "cuMemsetD8Async", "cuMemsetD32Async")


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
