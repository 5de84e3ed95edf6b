"""Mean device milliseconds of the port's ``train.forward`` phase a step
over the window's steps before the profiler started, timed by the
timing events the step's program records on the card
(``port_spans.phase_ms``)."""
from benchmark import port_spans


def read(records):
    return port_spans.phase_ms(records, "train.forward")
