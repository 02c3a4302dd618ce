"""Ice-domain decomposition over ``torch.distributed`` ranks (port of
``icebin_tpu/parallel/``): ``mesh`` (ranks and collectives),
``distributed`` (process groups, rank launch, field placement), ``halo``,
``sharded_apply`` (K1/K2 per rank), ``build`` (the exchange build with K3
per rank), ``coupled`` (the decomposed SIA step) and ``dryrun``."""
