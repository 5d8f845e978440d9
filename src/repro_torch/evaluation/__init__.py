"""Ensemble scores."""
