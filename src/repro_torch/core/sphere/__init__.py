"""Operators on the sphere: grids, SHT, DISCO, resampling, noise."""
