"""Training: optimizers and the CNN train step."""
