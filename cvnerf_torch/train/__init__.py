"""Training: the Adam state and the train step."""
