"""Runtime support: the typed errors and warnings of the profiler."""
