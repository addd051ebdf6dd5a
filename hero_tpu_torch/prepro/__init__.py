"""Data preparation (the port of ``hero_tpu.prepro`` and of the JAX
package's ``scripts/``): subtitle-frame alignment, tokenization, the store
builders, and the entry points ``python -m hero_tpu_torch.prepro.
{convert_videodb,prepro_sub,prepro_query,prepro_tvc,suggest_bucket,
build_dbs}``.  Nothing here needs a card."""
