"""Launchers: production mesh, the multi-pod dry run, the per-device cost
count and the per-op profile of one cell."""
