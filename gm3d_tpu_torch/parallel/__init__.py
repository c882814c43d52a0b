"""Data parallelism over several GPUs, one process each.

Port of ``gm3d_tpu/parallel``: the context that the batch norms, the draws
and the steps read (``context.py``), the process group and the host-side
gather (``multihost.py``), the batch shards and the steps' collectives
(``mesh.py``).
"""

from gm3d_tpu_torch.parallel.context import (
    DataParallel,
    draw_rows,
    get_context,
    replica_scope,
    set_context,
)
from gm3d_tpu_torch.parallel.mesh import (
    average_gradients,
    barrier,
    gather_rows,
    make_mesh,
    mean_over_ranks,
    reduce_gradients,
    replicate_tree,
    run_eval_batch,
    shard_batch,
    shard_eval_batch,
)
from gm3d_tpu_torch.parallel.multihost import gather_features, init_distributed, is_main_process

__all__ = [
    "DataParallel",
    "average_gradients",
    "barrier",
    "draw_rows",
    "gather_features",
    "gather_rows",
    "get_context",
    "init_distributed",
    "is_main_process",
    "make_mesh",
    "mean_over_ranks",
    "reduce_gradients",
    "replica_scope",
    "replicate_tree",
    "run_eval_batch",
    "set_context",
    "shard_batch",
    "shard_eval_batch",
]
