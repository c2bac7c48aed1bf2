"""Timing on the card for the measurement entry points and ``chip_smoke.py``.

Device time comes from ``torch.profiler``'s CUPTI trace (the kernels' own
time, without the host's launch cost); a launch loop's time comes from CUDA
events around it (host cost included). Both need a CUDA device.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile


# The kernel of torch.cuda._sleep, which brackets each trace's calls.
MARKER = "spin_kernel"
# Markers on each side of the calls: more than the kernels a trace has been
# seen to lose at either end, and launched for at least BRACKET_S seconds.
MARKERS = 64
BRACKET_S = 0.01
ATTEMPTS = 5
# Traces taken again because they lost a marker, in this process.
retakes = 0


def events_ms(fn: Callable[[], object], reps: int = 50, warmup: int = 5) -> float:
    """Mean ms per call of ``fn()`` over ``reps`` calls between two CUDA
    events: the launch loop's pace, host cost included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def self_device_us(event) -> float:
    return getattr(event, "self_device_time_total", getattr(event, "self_cuda_time_total", 0.0))


def device_us(prof) -> float:
    """Summed device time (us) of every kernel and copy a profile recorded."""
    return sum(self_device_us(e) for e in prof.key_averages())


def device_events(prof):
    """The kernels and copies of a trace, in the order they started."""
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(events, key=lambda e: e.time_range.start)


def device_profile(fn: Callable[[], object], reps: int = 50, warmup: int = 5, *,
                   setup: Optional[Callable[[], object]] = None,
                   kernel: Optional[str] = None) -> Tuple[float, float]:
    """(device ms, device operations) per call of ``fn()``: the summed
    device time and the count of kernels and copies in torch.profiler's
    CUPTI trace of ``reps`` calls.

    ``setup()``, if given, runs before every call (to give each call fresh
    inputs); its device work is in the trace, so it needs ``kernel``: only
    device events whose name holds it are summed, and the trace must hold
    exactly one of them per call.

    Late in a long process a trace can miss its first or its last kernels
    (a few, up to a few dozen), which would drop calls from the sums. So the
    calls run between two runs of marker kernels (MARKERS of them, and more
    until BRACKET_S has passed), and a trace counts only if its earliest and
    its latest device events are markers and the calls between them hold
    device time (a late trace has also dropped every call between intact
    markers); otherwise it is taken again, so ``fn`` may run more than
    ``warmup + reps`` times. Raises if ATTEMPTS traces all failed that."""
    global retakes
    if setup is not None and kernel is None:
        raise ValueError("a setup's device work needs a kernel name to leave it out")

    def call():
        if setup is not None:
            setup()
        fn()

    def bracket():
        began = time.perf_counter()
        for _ in range(MARKERS):
            torch.cuda._sleep(100)
        while time.perf_counter() - began < BRACKET_S:
            torch.cuda._sleep(100)
            torch.cuda.synchronize()
        torch.cuda.synchronize()

    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    lost = []
    for attempt in range(ATTEMPTS):
        retakes += attempt > 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            bracket()
            for _ in range(reps):
                call()
            bracket()
        events = device_events(prof)
        calls = [e for e in events
                 if MARKER not in e.name and (kernel is None or kernel in e.name)]
        total_us = sum(e.time_range.elapsed_us() for e in calls)
        if events and MARKER in events[0].name and MARKER in events[-1].name and total_us > 0:
            break
        lost.append((len(events), sum(MARKER in e.name for e in events),
                     events[0].name[:40] if events else None,
                     events[-1].name[:40] if events else None, total_us))
        logging.warning(f"profiler trace {attempt + 1} lost its first or last kernels, or "
                        f"every call's (events, markers, first, last, call us): {lost[-1]}")
    else:
        raise RuntimeError(f"{ATTEMPTS} profiler traces lost their first or last kernels, or "
                           f"held no device time for the calls (events, markers, first, "
                           f"last, call us): {lost}")
    if kernel is not None and len(calls) != reps:
        raise RuntimeError(f"{len(calls)} {kernel} kernels traced in {reps} calls")
    return total_us / reps / 1e3, len(calls) / reps
