"""Ensemble training and checkpoints."""
