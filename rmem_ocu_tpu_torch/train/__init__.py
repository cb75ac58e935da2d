"""Training: the optimizer pieces and the train step."""
