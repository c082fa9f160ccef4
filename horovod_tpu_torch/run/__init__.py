"""The port's rendezvous plane and launcher: the port of
``horovod_tpu/run/``.

``python -m horovod_tpu_torch.run -np N [-H ...] <command>`` launches a
job, one process a card (``run.py``); :func:`run` runs a function on N
local processes.  The KV plane is ``store.py`` / ``http_server.py`` /
``http_client.py`` / ``journal.py`` / ``relay.py``.
"""

from .run import run, run_commandline  # noqa: F401
