"""Entry points over whole datasets: pretraining (``pretrain``, with the
train loop in ``common``), TVC caption generation and the TVC train
step."""
