"""Card-idle milliseconds a traced tick while the host is inside the
port's ``program.stage`` spans (a program's inputs copied in through
pinned memory), the spans placed on the trace's clock by their tick's
offset (``port_spans.tick_idle``)."""
from benchmark import port_spans


def read(records):
    ticks = port_spans.tick_idle(records)
    return port_spans.mean_ms([t["stage"] for t in ticks]) if ticks else None
