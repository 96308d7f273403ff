"""Models of the port: the transformer stacks, whisper, their layers and
the training loss (``api.lm_loss``)."""
