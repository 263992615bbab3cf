"""The harness of the port's benchmark (see ../run.py)."""
