"""Command-line drivers of the port (``serve.py``, ``train.py``)."""
