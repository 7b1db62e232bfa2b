"""Named stage spans and the device profile the benches print.

Every stage of the render and train paths runs inside :func:`span`, a
``torch.profiler.record_function`` range named ``gfnerf/<stage>``.  Inside
:func:`profile_device` each span also records a pair of CUDA events on the
current stream, so a stage's device span (first kernel start to last kernel
end, gaps included) is read the same way for every stage, the backward
pass included, whose kernels PyTorch launches from its own thread.  With
the profile off a span costs one ``record_function`` and one check.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

# [(stage, start event, end event)] while profile_device runs, else None.
# Module state because the spans sit deep in the model code, which no
# recorder object reaches; only profile_device sets it, and resets it.
_events = None

# CUDA runtime calls through which the host may wait for the device: the
# synchronizes, and cudaMemcpyAsync, which PyTorch follows with a stream
# synchronize when it copies from the host's pageable memory
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpyAsync")


@contextlib.contextmanager
def span(name: str):
    """Run the body as stage ``name``."""
    with record_function(f"gfnerf/{name}"):
        if _events is None:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            _events.append((name, start, end))


def profile_device(fn) -> dict:
    """Run fn() once under torch.profiler, with stage events on.

    Returns the device span (ms) of each stage summed over its entries, the
    sum of all kernel times (the device's busy time), the busiest kernels,
    and the count of each of HOST_WAITS."""
    global _events
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _events = []
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        stages = {}
        for name, start, end in _events:
            stages[name] = stages.get(name, 0.0) + start.elapsed_time(end)
    finally:
        _events = None
    events = prof.key_averages()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in events
                      if e.device_type == DeviceType.CUDA
                      and not e.key.startswith("gfnerf/")),
                     key=lambda k: -k[1])
    return {"stage_device_span_ms": stages,
            "device_busy_ms": sum(k[1] for k in kernels),
            "top_kernels": [{"name": n[:100], "device_ms": t, "count": c}
                            for n, t, c in kernels[:15]],
            "host_waits": {e.key: e.count for e in events
                           if e.key in HOST_WAITS}}
