"""Numpy batch builders (copies of the hero_tpu.data pieces the serving
and training paths need)."""
