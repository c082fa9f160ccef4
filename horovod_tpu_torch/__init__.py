"""horovod_tpu_torch — the PyTorch / CUDA port of horovod_tpu.

A second package beside the JAX one, which stays the reference: each
module is named after the module it ports, and its tests hold it against
the reference on the same inputs.  This package imports torch and numpy,
never JAX or anything of ``horovod_tpu``.  Its entry points run on the
CUDA device unless the caller passes ``device="cpu"``.

The first slice is the data-parallel ResNet training step with the fused
optimizer update, whose kernel (K1, ``csrc/fused_update.cu``) is written
by hand for Hopper.
"""

from .core import (  # noqa: F401
    Adasum, Average, Max, Min, Sum,
    ccl_built, cross_rank, cross_size, cuda_built, ddl_built, device,
    gloo_built, gloo_enabled, init, is_homogeneous, is_initialized,
    local_rank, local_size, mpi_built, mpi_enabled, mpi_threads_supported,
    nccl_built, process_rank, process_size, rank, rocm_built, shutdown, size,
    xla_built,
)
from .ops.collectives import allreduce, broadcast  # noqa: F401
from .ops.compression import Compression  # noqa: F401
from .ops.fusion import (  # noqa: F401
    FusionPlan, allreduce_pytree, fused_allreduce, tree_leaf_names,
)
from .optim.fused_update import (  # noqa: F401
    FusedOptimizer, FusedOptState, fused_adam, fused_sgd,
)
from .training import (  # noqa: F401
    TrainState, init_train_state, make_train_step, shard_batch,
)
