"""PyTorch/CUDA port of the tpusched workload layer (``tpusched/jaxbridge``).

Modules mirror the reference by name: ``workload`` (config, parameters,
forward, train steps, and the shardings of data, fully-sharded, sequence,
expert and tensor parallelism), ``pipeline`` (the GPipe schedule over pp),
``attention`` (naive attention and FlashAttention-2, whose forward and
backward CUDA kernels live in ``csrc/``), ``decode`` (KV cache, prefill,
decode, sampling, keyed sampling and the speculative draft rollout),
``serve`` (the continuous-batching engine and its measurement harnesses),
``spec_decode`` (solo speculative generation and sampling), ``measure``
(train-step and decode timing, FLOPs, MFU and bandwidth), ``optim``
(optax's AdamW), ``mesh`` (named device meshes over ``torch.distributed``
and their collectives) and ``interop`` (weights carried across from the
reference as numpy arrays). The package imports torch and numpy only; it
never imports JAX or ``tpusched``.
"""
