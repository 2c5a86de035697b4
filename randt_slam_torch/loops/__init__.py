"""Loop closure: ScanContext descriptors and retrieval, the batched detector."""
