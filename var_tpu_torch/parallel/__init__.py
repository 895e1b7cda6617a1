"""Data parallelism on torch.distributed (port of var_tpu/parallel/)."""
from var_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_gather_env,
    all_reduce_sum_,
    broadcast_,
    build_mesh,
    init_distributed,
    launch,
    mesh_size,
    pad_to_multiple,
    run_on_lead,
)
