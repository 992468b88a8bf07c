"""The UDG port's benchmark: one command runs one cell once (``run.py``);
cells, configurations, traffic mixes and metrics are found by name
(``spec.py``, ``README.md``)."""
