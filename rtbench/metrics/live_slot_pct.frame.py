"""live_slot_pct.frame: the live ray slots over all the slots that the
wavefront's levels >= 1 carried, in percent (the program's counters,
``render/wavefront.py::slot_counts``), over frames rendered again once the
traced window has closed (rtbench/program_spans.py)."""

from rtbench import program_spans


def read(run):
    s = program_spans.read(run)
    if s is None or s.slots is None or s.slots[0] <= 0:
        return None
    carried, live = s.slots
    return 100.0 * live / carried
