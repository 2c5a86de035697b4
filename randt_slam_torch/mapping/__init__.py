"""Occupancy-grid mapping: raytracing and the global OGM."""
