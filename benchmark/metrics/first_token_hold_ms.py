"""Mean milliseconds from the end of the port's ``serve.admit`` (the
request's first token on the host) to the end of its ``serve.tick``
(when the tick returns it), over the admissions of the window's admit
ticks outside the profiled part."""
from benchmark import port_spans


def read(records):
    got = port_spans.admissions(records)
    if not got:
        return None
    return 1e3 * sum(tick["t1"] - adm["t1"] for adm, tick in got) / len(got)
