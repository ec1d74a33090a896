"""Data parallelism over processes, one a device (``mesh.py``,
``distributed.py``)."""
