"""secondary_ms.frame: device time of the wavefront's levels >= 1 (the
program's spans ``wavefront.level.<l>``), in milliseconds per frame, over
frames rendered again once the traced window has closed
(rtbench/program_spans.py)."""

from rtbench import program_spans


def _secondary(name):
    m = program_spans.LEVEL.match(name)
    return m is not None and int(m.group(1)) >= 1


def read(run):
    return program_spans.span_ms(run, _secondary)
