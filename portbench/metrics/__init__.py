"""One reader per per-layer metric, ``<metric>.py``: ``read(run)`` returns the
metric from a traced run (``harness.Run``: ``main``, the untraced window, and
``traced``, the profiled one after it, each a ``harness.Window``; ``trace``,
the profiler's reduction of the second; the cell), or None where it finds
nothing to read."""
