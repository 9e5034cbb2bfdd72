from . import profiling
