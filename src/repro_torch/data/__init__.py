"""The port's data: the synthetic packed-LM batches of ``pipeline``."""
