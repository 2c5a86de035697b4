"""Sliding-window scan-to-submap registration."""
