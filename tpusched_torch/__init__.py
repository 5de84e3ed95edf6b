"""PyTorch/CUDA port of the tpusched workload layer (``tpusched/jaxbridge``).

Modules mirror the reference by name: ``workload`` (config, parameters,
forward), ``attention`` (naive attention and the flash forward, whose CUDA
kernel lives in ``csrc/``), ``decode`` (KV cache, prefill, decode,
sampling), ``serve`` (the continuous-batching engine) and ``interop``
(weights carried across from the reference as numpy arrays). The package
imports torch and numpy only; it never imports JAX or ``tpusched``.
"""
