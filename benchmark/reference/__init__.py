"""The plain PyTorch reference the serving cells are judged against. It
imports neither JAX, the JAX package nor ``tpusched_torch``."""
