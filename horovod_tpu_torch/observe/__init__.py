"""Observability of the control plane: the flight recorder
(``events.py``), the port of ``horovod_tpu/observe/``."""
