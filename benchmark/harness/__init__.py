"""The port's benchmark harness (see ``benchmark/run.py``)."""
