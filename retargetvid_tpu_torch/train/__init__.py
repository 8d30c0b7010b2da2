"""Inference datasets of the port (the training slice adds the rest)."""
