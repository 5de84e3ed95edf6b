"""One reader a per-layer quantity, loaded by path (``harness.Bench.reader``):
a metric named ``<quantity>.<variant>`` in BENCHMARK.json is read by
``<quantity>.<variant>.py`` where that file exists, else by
``<quantity>.py``. What BENCHMARK.json states of a metric (layer, unit,
source, what it moves, its cells) is stated there alone."""
