"""One reader a per-layer metric, ``metrics/<name>.py`` with ``read(ctx)``:
its value from the traced run's context (run.py, ``Context``), or None
where the cell gives it nothing to read, and the harness leaves it out."""
