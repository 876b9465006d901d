"""Data parallelism (`mesh.py`: process groups, rank slices, gathers of the
global batch, the logged losses' mean) and the sequence-parallel scan
(`sp_scan.py`). Counterpart of `vmambair_tpu/parallel/`."""

from .mesh import (
    all_gather_batch,
    barrier,
    default_sp_group,
    destroy_distributed,
    init_distributed,
    is_main_process,
    local_batch_slice,
    on_global_batch,
    rank,
    reduce_log_dict,
    set_default_sp_group,
    use_sp_group,
    world_size,
)

__all__ = ["all_gather_batch", "barrier", "default_sp_group",
           "destroy_distributed", "init_distributed", "is_main_process",
           "local_batch_slice", "on_global_batch", "rank", "reduce_log_dict",
           "set_default_sp_group", "use_sp_group", "world_size"]
