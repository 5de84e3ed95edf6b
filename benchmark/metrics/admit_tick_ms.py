"""Mean host-clock time of the window's admit ticks (the engine's
``prefills`` counter rose: whole prompts prefilled in the tick, then the
decode step)."""
from benchmark import readers


def read(records):
    return readers.mean_tick_ms(records, admitting=True)
