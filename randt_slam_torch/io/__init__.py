"""Readers and writers: synthetic worlds, converted sequences, trajectory formats."""
