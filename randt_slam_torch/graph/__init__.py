"""Pose-graph optimization."""
