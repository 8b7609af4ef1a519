"""Checkpoints and the statistical gate of the torch port."""
