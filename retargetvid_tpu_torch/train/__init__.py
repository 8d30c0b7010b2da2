"""Datasets, losses, the trainer and the runtime/size measures of the port."""
