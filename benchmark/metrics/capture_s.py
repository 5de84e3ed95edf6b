"""Host seconds of the port's ``program.warmup`` and ``program.capture``
spans before the window: every program's warm-up call and capture (the
train program's warm-up is its eager first step)."""
from benchmark import port_spans


def read(records):
    return port_spans.capture_seconds(records)
