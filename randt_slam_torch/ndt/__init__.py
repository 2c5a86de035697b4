"""NDT cells and the sparse submap grid."""
