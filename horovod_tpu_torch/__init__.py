"""horovod_tpu_torch — the PyTorch / CUDA port of horovod_tpu.

A second package beside the JAX one, which stays the reference: each
module is named after the module it ports, and its tests hold it against
the reference on the same inputs.  This package imports torch and numpy,
never JAX or anything of ``horovod_tpu``.  Its entry points run on the
CUDA device unless the caller passes ``device="cpu"``.

Its kernels (``csrc/``) are written by hand for Hopper; on a CUDA device
the training step runs as one captured CUDA graph.

The reference's SPMD surface has thin forms here where it has a meaning
in a process-per-card world: :func:`mesh` and :func:`hierarchical_mesh`
are ``DeviceMesh``es of the world, :func:`in_spmd` is False and the
axis names are the reference's.  ``spmd``, ``rank_context``,
``sharded``, ``replicated``, ``put_per_rank`` and ``get_per_rank`` have
none: the code every rank runs is the SPMD region, and a process holds
only its own rank's values (``ROADMAP.md``, "Decisions").
"""

__version__ = "0.1.0"  # the reference's (horovod_tpu/__init__.py)

from .core import (  # noqa: F401
    AXIS, CROSS_AXIS, LOCAL_AXIS, Adasum, Average, Max, Min, Sum,
    ccl_built, cross_rank, cross_size, cuda_built, ddl_built, device,
    gloo_built, gloo_enabled, hierarchical_mesh, in_spmd, init,
    is_homogeneous, is_initialized, local_rank, local_size, mesh, mpi_built,
    mpi_enabled, mpi_threads_supported, nccl_built, process_rank,
    process_size, rank, reinit, rocm_built, shutdown, size, xla_built,
)
from .ops.collectives import (  # noqa: F401
    ProcessSet, allgather, allgatherv, allreduce, allreduce_gradients,
    alltoall, broadcast, grouped_allreduce, reducescatter,
)
from .ops.compression import Compression, ErrorFeedback  # noqa: F401
from .ops.fusion import (  # noqa: F401
    FusionPlan, allreduce_pytree, fused_allreduce, tree_leaf_names,
)
from .ops.sparse import (  # noqa: F401
    IndexedSlices, allreduce_indexed_slices, embedding_grad_as_slices,
)
from .parallel.hierarchical import two_level_allreduce  # noqa: F401
from .eager import allgather_object, broadcast_object  # noqa: F401
from .elastic.join import join, join_allreduce  # noqa: F401
from .elastic import HorovodAbortError, abort  # noqa: F401
from .optim.distributed import (  # noqa: F401
    DistributedGradientTape, DistributedOptimizer, broadcast_optimizer_state,
    broadcast_parameters, broadcast_variables,
)
from .optim.fused_update import (  # noqa: F401
    FusedOptimizer, FusedOptState, fused_adam, fused_sgd,
)
from .training import (  # noqa: F401
    TrainState, init_train_state, make_train_step, shard_batch,
)
