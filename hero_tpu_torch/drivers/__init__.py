"""Entry points over whole datasets (TVC caption generation)."""
