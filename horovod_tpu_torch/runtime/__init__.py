"""The native runtime core, loaded with ctypes (``native.py``): the
port of ``horovod_tpu/runtime/``'s loader, for the timeline writer."""
