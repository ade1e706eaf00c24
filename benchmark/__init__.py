"""The benchmark of startrax_torch: one cell run once on one GPU (run.py)."""
