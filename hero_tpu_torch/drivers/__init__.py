"""Entry points over whole datasets: TVC caption generation and the TVC
train step."""
