"""Kernel timing on a CUDA card, two ways.

``event_ms`` times back-to-back eager calls between two CUDA events: when
a call's device work is shorter than its host cost (argument checks, the
allocation, the ctypes call, the launch), that is the host's enqueue rate.
``graph_ms`` captures the calls into one CUDA graph and times its replays,
which leaves only the device time per launch.

This module imports nothing else of the package, so a script can load it
by its file path beside another checkout's kernels.
"""

from __future__ import annotations

import torch


def event_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Mean device milliseconds per call of ``fn``, free of host cost:
    ``launches`` calls captured into one CUDA graph, the graph replayed
    ``replays`` times between two CUDA events. ``fn`` first runs outside the
    capture, on the capture's side stream, so that no build and no first-use
    setup falls inside the graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * launches)
