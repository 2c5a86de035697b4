from . import checkpoint, profiling  # noqa: F401
