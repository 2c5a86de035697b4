"""Multi-sequence batching: B sequences through one front end per device."""
