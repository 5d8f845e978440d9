"""Synthetic data on the device."""
