"""Several ranks: data-parallel training and multi-process serving over
``torch.distributed`` (``dist``; counterpart of ``hero_tpu/parallel``)."""
