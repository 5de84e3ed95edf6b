"""Mean host-clock time of the window's ticks that admitted nothing: one
decode step over the arena."""
from benchmark import readers


def read(records):
    return readers.mean_tick_ms(records, admitting=False)
