"""The benchmark of tpusched_torch: cells of BENCHMARK.json run one at a time
by ``python3 -m benchmark.run``. Nothing here imports JAX or the JAX
package ``tpusched``; the plain reference under ``reference/`` imports
nothing of ``tpusched_torch`` either."""
