from visual_onoma_to_wave_tpu_torch.parallel.distributed import (
    all_reduce_grads,
    all_reduce_tensors,
    barrier,
    broadcast_module,
    host_tree,
    init_distributed,
    is_multiprocess,
    is_primary,
    local_device,
    process_count,
    process_index,
    shard_batch_multiprocess,
)
from visual_onoma_to_wave_tpu_torch.parallel.serving import make_sharded_synth

__all__ = [
    "all_reduce_grads",
    "all_reduce_tensors",
    "barrier",
    "broadcast_module",
    "host_tree",
    "init_distributed",
    "is_multiprocess",
    "is_primary",
    "local_device",
    "make_sharded_synth",
    "process_count",
    "process_index",
    "shard_batch_multiprocess",
]
