"""Loop-closure descriptors."""
