"""Multi-sequence batching (B sequences through one front end per device)
and multi-device runs (one process per card, ``mesh.py``)."""
