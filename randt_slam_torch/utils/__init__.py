# ``checkpoint`` is imported where it is used: it reaches the pipeline, whose
# modules import ``profiling``.
from . import profiling  # noqa: F401
