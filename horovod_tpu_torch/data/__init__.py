"""Host data loading: the port of ``horovod_tpu/data/``."""

from .loader import ShardedLoader, prefetch_to_device  # noqa: F401
