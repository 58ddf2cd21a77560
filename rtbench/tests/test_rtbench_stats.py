"""The rate arithmetic of the end-to-end metrics and the reduction of a
traced window."""

import time
from types import SimpleNamespace as NS

import pytest

from rtbench import trace, workload
from rtbench.run import load_metric


class _Sleeper:
    """Items of ``base`` seconds, one of them (the third) ``stall``."""

    def __init__(self, base, stall):
        self.base, self.stall, self.n = base, stall, 0

    def item(self):
        time.sleep(self.stall if self.n == 2 else self.base)
        self.n += 1


def _window(kind, stall):
    run = workload.Run(cell="c", kind=kind, seed=0, traffic={})
    workload.measure(run, _Sleeper(0.01, stall), 0.2, False, "cpu")
    return run


@pytest.mark.parametrize("kind,metric", [("orbit", "frame_ms"),
                                         ("fit", "fit_step_ms")])
def test_rate_is_the_window_over_its_items(kind, metric):
    run = _window(kind, 0.01)
    ms = load_metric(metric).read(run)
    assert ms == pytest.approx(run.window_s / run.items * 1e3)
    assert ms >= 10.0 and run.window_s >= 0.2
    other = {"frame_ms": "fit_step_ms", "fit_step_ms": "frame_ms"}[metric]
    assert load_metric(other).read(run) is None


def test_a_stall_inside_the_window_moves_the_rate():
    calm, stalled = _window("orbit", 0.01), _window("orbit", 0.15)
    read = load_metric("frame_ms").read
    assert max(stalled.item_s) >= 0.15
    # The stall's time stays in the window: the rate takes it whole.
    assert stalled.window_s >= sum(stalled.item_s)
    assert read(stalled) > read(calm) * 1.5


def test_merged_span():
    assert trace.merged_span([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]


def _event(name, start, end, cuda=False, thread=1):
    from torch.autograd import DeviceType

    return NS(name=name, time_range=NS(start=start, end=end), thread=thread,
              device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


def test_summary_of_a_window():
    ev = [_event(trace.ITEM, 0, 100), _event(trace.ITEM, 100, 200),
          _event("aten::add", 5, 40), _event(trace.SYNC, 60, 90),
          _event("walk_kernel<false, 1, false>", 10, 50, cuda=True),
          _event("other_kernel", 45, 70, cuda=True),
          _event("walk_kernel<true, 2, false>", 120, 150, cuda=True),
          _event(trace.SYNC, 150, 190, thread=2),
          # A record_function span on the device's timeline: no operation.
          _event("rtbench.render", 0, 200, cuda=True)]
    s = trace.summarize(NS(events=lambda: ev))
    assert (s.items, s.window_us, s.busy_us) == (2, 200, 90)
    assert (s.syncs, s.sync_us) == (1, 30)
    assert s.kernel_ms_per_item(trace.WALK_KERNELS) == pytest.approx(0.035)
    # Idle: [0, 10) in aten::add, [70, 120) in the sync (mid 95 is past it:
    # outside any recorded op), [150, 200) outside.
    assert s.idle_by_host == {"aten::add": 10, trace.OUTSIDE: 100}
    b = s.breakdown()
    assert b["device_ops"][0] == ["walk_kernel<false, 1, false>", 40e-6]
    reads = {n: load_metric(n).read(NS(summary=s, kind="orbit"))
             for n in ("walk_ms.frame", "host_sync_ms.frame",
                       "device_idle_pct.frame")}
    assert reads == {"walk_ms.frame": pytest.approx(0.035),
                     "host_sync_ms.frame": pytest.approx(0.015),
                     "device_idle_pct.frame": pytest.approx(55.0)}
