"""One module a model architecture, named by the configuration file's
``model_type`` (``model.arch``). Each gives, for a configuration file:

- ``port_config(conf, **overrides)``: the port's ``tpusched_torch.workload.
  ModelConfig``, refusing what the port cannot run;
- ``leaves(conf)``: every leaf of the weights (``model.Leaf``: path, shape,
  dtype, how it is made), in a fixed order; layers may differ;
- ``counts(conf)``: the arithmetic's sizes (``flops.Counts``, one
  ``flops.Layer`` a layer), which the per-layer metrics read;
- ``experts_per_token(conf)``: the experts a token is routed to, 0 where
  the architecture does not route.

Its plain reference is ``reference/<model_type>.py``."""
