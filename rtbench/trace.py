"""The traced window: torch.profiler over the timed items, reduced to what
the per-layer metrics read.

``merged_span`` is ``chip_smoke.py::_merged_span`` and the blocking-read
count (``aten::_local_scalar_dense`` on the host) is
``chip_smoke.py::_profile``'s, both copied at commit ee2838e.

Each timed item (a frame or a fit step) runs inside a
``record_function(ITEM)`` span, and its calls into the program inside
spans of their own (``rtbench.render``, ``rtbench.to_bytes``;
``rtbench.step``, ``rtbench.read_loss``), so that an idle gap of the
device is named by the innermost host span or op around it; the traced
window runs from the first item's start to the last item's end.  Every
frame and step ends in a host read of its result, so the device work of
an item lies inside its span.
"""

from __future__ import annotations

from typing import NamedTuple

ITEM = "rtbench.item"
WALK_KERNELS = ("walk_kernel", "subwalk_kernel", "prepick_kernel",
                "mxu_walk_kernel")
SYNC = "aten::_local_scalar_dense"
OUTSIDE = "host code outside any recorded op"


def merged_span(intervals):
    """Total length covered by (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Summary(NamedTuple):
    """Microseconds, from one traced window of ``items`` items."""

    items: int
    window_us: float
    busy_us: float
    kernel_us: dict       # device operation name -> total us in the window
    sync_us: float        # host time blocked in reads of device values
    syncs: int
    idle_by_host: dict    # what the host was doing -> us of device idle

    def kernel_ms_per_item(self, needles):
        total = sum(us for name, us in self.kernel_us.items()
                    if any(n in name for n in needles))
        return total / self.items / 1e3

    def breakdown(self, top=10):
        ops = sorted(self.kernel_us.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], us / 1e6] for n, us in ops],
                "idle_gaps": [[n[:160], us / 1e6] for n, us in gaps]}


def _host_name(stack_events, mids):
    """For each gap midpoint (sorted), the innermost host event covering it
    on the items' thread."""
    names, stack, j = [], [], 0
    for mid in mids:
        while j < len(stack_events) and stack_events[j][0] <= mid:
            s, e, name = stack_events[j]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((s, e, name))
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        names.append(stack[-1][2] if stack else OUTSIDE)
    return names


def summarize(prof) -> Summary | None:
    """The window of ``prof`` (a finished torch.profiler.profile); None when
    it holds no item or no device activity."""
    from torch.autograd import DeviceType

    events = prof.events()
    items = [e for e in events if e.name == ITEM
             and e.device_type == DeviceType.CPU]
    if not items:
        return None
    w0 = min(e.time_range.start for e in items)
    w1 = max(e.time_range.end for e in items)
    thread = items[0].thread
    # record_function spans (the harness's, torch.optim's, the program's)
    # also appear on the device's timeline as annotations: not operations.
    notes = {e.name for e in events if getattr(e, "is_user_annotation", False)
             and e.device_type == DeviceType.CPU}
    dev, host = [], []
    kernel_us, sync_us, syncs = {}, 0.0, 0
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA and (
                getattr(e, "is_user_annotation", False) or e.name in notes
                or e.name.startswith("rtbench.")):
            continue
        if e.device_type == DeviceType.CUDA:
            s, t = max(s, w0), min(t, w1)
            if t > s:
                dev.append((s, t))
                kernel_us[e.name] = kernel_us.get(e.name, 0.0) + (t - s)
        elif e.thread == thread and w0 <= s <= w1:
            if e.name == SYNC:
                sync_us += t - s
                syncs += 1
            if e.name != ITEM:
                host.append((s, t, e.name))
    if not dev:
        return None
    busy = merged(dev)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    gaps = [(w0, busy[0][0])] + gaps + [(busy[-1][1], w1)]
    gaps = [(s, e) for s, e in gaps if e > s]
    host.sort(key=lambda x: (x[0], -x[1]))
    mids = [(s + e) / 2 for s, e in gaps]
    order = sorted(range(len(mids)), key=mids.__getitem__)
    named = _host_name(host, [mids[i] for i in order])
    idle = {}
    for i, name in zip(order, named):
        s, e = gaps[i]
        idle[name] = idle.get(name, 0.0) + (e - s)
    return Summary(items=len(items), window_us=w1 - w0,
                   busy_us=merged_span(dev), kernel_us=kernel_us,
                   sync_us=sync_us, syncs=syncs, idle_by_host=idle)
