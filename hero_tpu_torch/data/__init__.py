"""Numpy batch builders and loaders (copies of the hero_tpu.data pieces
the serving and training paths need: the herostore databases and their
msgpack subset, the video dataset, the pretraining task datasets, the
MetaLoader and the prefetch to the card)."""
