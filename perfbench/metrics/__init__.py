"""One per-layer metric a file: ``<name>.py`` holds ``read(run)``, which
returns the metric's number from a ``run.Run``, or None where it finds
nothing to read."""
