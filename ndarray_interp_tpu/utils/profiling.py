"""Profiling/tracing helpers.

The reference ships only wall-clock criterion benches (SURVEY.md §5);
observability here is XLA-level traces.  These wrappers
put a stable API around ``jax.profiler``:

* :func:`trace` — context manager writing a TensorBoard-loadable trace,
* :func:`annotate` — name a region so it shows up in the trace timeline,
* :func:`device_memory_stats` — current per-device memory counters.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Capture an XLA profiler trace of the enclosed block::

        with profiling.trace("/tmp/ndi_trace"):
            interp.interp_array(queries).block_until_ready()
    """
    jax.profiler.start_trace(log_dir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region annotation (shows up in the trace timeline)."""
    return jax.profiler.TraceAnnotation(name)


def device_memory_stats(device=None) -> dict:
    dev = device or jax.devices()[0]
    stats = getattr(dev, "memory_stats", lambda: None)()
    return dict(stats) if stats else {}
