"""Entry points of the port's model zoo (``serve``; training, dry runs and
the mesh launchers come with ROADMAP.md queue 1 items 12 and 14)."""
