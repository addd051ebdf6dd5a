"""Preprocessing logic (copies of the hero_tpu.prepro pieces the port
needs)."""
