"""The program's own spans and counters in ``render/wavefront.py`` (the
spans ``wavefront.level.<l>``, ``wavefront.compact`` and
``wavefront.combine``; ``slot_counts``), over frames of the orbit rendered
again once the traced window has closed, under a profiler of their own:
the window's summary (trace.summarize) keeps no annotation.

A span's device time is the device's busy time inside the span's window
on the device's timeline (torch.profiler puts each ``record_function``
there too, from the first to the last operation launched in it): the
frame runs on one stream, so the operations in that window are the
span's, the walks' kernels included, whichever host op launched them.

Read by secondary_ms.frame, compact_ms.frame and live_slot_pct.frame.  A
program without these spans or counters gives nothing to read, and the
readers give None.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional

import torch

from rtbench import trace

FRAMES = 2
LEVEL = re.compile(r"wavefront\.level\.(\d+)$")


class Spans(NamedTuple):
    frames: int
    device_us: dict         # span -> device busy time inside its window
    slots: Optional[tuple]  # (carried, live) of the levels >= 1, or None


def read(run) -> Optional[Spans]:
    """The spans of ``FRAMES`` frames from the window's first pose, profiled
    once a run (kept on its mix); None without a card or a frame mix."""
    mix = run.mix
    if run.kind != "orbit" or mix is None:
        return None
    if getattr(mix, "program_spans", None) is not None:
        return mix.program_spans
    if mix.render is None or not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile

    from raytpu_torch.render import wavefront

    counts = getattr(wavefront, "slot_counts", None)
    before = counts() if counts else None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(FRAMES):
            mix.render(mix.first + i)
        torch.cuda.synchronize()
    slots = None
    if counts:
        slots = tuple(a - b for a, b in zip(counts(), before))
    mix.program_spans = Spans(FRAMES, span_device_us(prof.events()), slots)
    return mix.program_spans


def span_device_us(events) -> dict:
    """{span: device busy microseconds inside its windows} from a
    profile's events: the device's operations merged, each ``wavefront.``
    window on the device's timeline intersected with them."""
    from torch.autograd import DeviceType

    windows, ops = [], []
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        if e.name.startswith("wavefront."):
            windows.append((e.name, span))
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name.startswith("rtbench.")):
            ops.append(span)
    busy = trace.merged(ops)
    out = {}
    for name, (s, t) in windows:
        inside = sum(max(0.0, min(t, b) - max(s, a)) for a, b in busy)
        out[name] = out.get(name, 0.0) + inside
    return out


def span_ms(run, keep) -> Optional[float]:
    """Device milliseconds a frame under the spans whose name ``keep``
    accepts; None where there are none, or they hold no device time."""
    s = read(run)
    if s is None:
        return None
    us = sum(v for k, v in s.device_us.items() if keep(k))
    return us / s.frames / 1e3 if us > 0 else None
