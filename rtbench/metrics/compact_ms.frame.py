"""compact_ms.frame: device time of the live-first permutation between the
dual-branch levels (the program's span ``wavefront.compact``), in
milliseconds per frame, over frames rendered again once the traced window
has closed (rtbench/program_spans.py)."""

from rtbench import program_spans


def read(run):
    return program_spans.span_ms(run, lambda name: name == "wavefront.compact")
