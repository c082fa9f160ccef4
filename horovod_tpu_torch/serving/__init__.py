"""Traffic-driven autoscaling serving plane: the port of
``horovod_tpu/serving/``.

Turns a trained checkpoint into a horizontally-scalable inference
service on the machinery the training runtime already has: replicas
load weights through ``utils/checkpoint`` (optionally int8/fp8-
compressed at rest), a continuous-batching engine bounds queueing delay
and the graphs captured (``HVD_SERVE_MAX_BATCH`` /
``HVD_SERVE_MAX_WAIT_MS`` / padded-shape buckets, one CUDA graph each on
the card), the rendezvous HTTP server fronts the request plane (signed
``POST /infer``, ``GET /serving``), the metrics plane carries the SLO
signals (``hvd_serve_*``), and the versioned-epoch elastic membership
scales the fleet with *load* — queue depth and p99-vs-SLO headroom
commit grow/shrink epochs without relaunch and without dropping
in-flight requests (the drain handshake, elastic/driver.py).

Entry points: ``python -m horovod_tpu_torch.run --serve``, ``python -m
horovod_tpu_torch.serving``, and the in-process
:class:`~horovod_tpu_torch.serving.plane.LocalServingPlane`.
"""

from .autoscaler import AutoscalePolicy, ServingAutoscaler  # noqa: F401
from .batching import (  # noqa: F401
    BatchBucketer,
    ContinuousBatcher,
    bucket_sizes_from_env,
)
from .broker import (  # noqa: F401
    QueueFullError,
    Request,
    RequestBroker,
    percentile,
)
from .frontend import ServingFrontend  # noqa: F401
from .loadgen import (  # noqa: F401
    OpenLoopLoadGenerator,
    bursty_arrivals,
    poisson_arrivals,
    summarize,
)
from .plane import (  # noqa: F401
    LocalServingPlane,
    make_mlp_serving_fn,
    run_bench_fixture,
    run_serving_fixture,
)
from .replica import (  # noqa: F401
    InferenceReplica,
    RemoteSource,
    compress_params,
    decompress_params,
    load_params,
    module_apply_fn,
    serve_worker_loop,
)
