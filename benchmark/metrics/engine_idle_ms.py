"""Card-idle milliseconds a traced tick while the host is inside the
port's ``serve.tick`` and outside its ``program.stage`` spans: the
engine's own Python, the replays' launches, the read-back's tail, a
collection (``port_spans.tick_idle``)."""
from benchmark import port_spans


def read(records):
    ticks = port_spans.tick_idle(records)
    return port_spans.mean_ms([t["engine"] for t in ticks]) if ticks else None
