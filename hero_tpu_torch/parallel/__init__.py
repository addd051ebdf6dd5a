"""Several ranks over ``torch.distributed`` (counterpart of
``hero_tpu/parallel``): the process group, its grid and the data-parallel,
tensor- and sequence-parallel collectives (``dist``), which leaves shard
over which ranks (``mesh``), and GPipe over pipeline stages
(``pipeline``)."""
