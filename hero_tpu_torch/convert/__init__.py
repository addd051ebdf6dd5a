"""Parameter bridges into the port's layout, and the converters of the
reference's ``.pt`` and RoBERTa checkpoints to the JAX layout."""
