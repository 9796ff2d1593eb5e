from stereo_vo_tpu_torch.parallel.distributed import (
    initialize_multihost,
    local_dp_block,
    shard_for_host,
    spawn_ranks,
)
from stereo_vo_tpu_torch.parallel.mesh import make_mesh
from stereo_vo_tpu_torch.parallel.sharded_ba import (
    dp_sharded_bundle_adjust,
    sharded_bundle_adjust,
    sharded_lm_solve,
    window_to_landmark_major,
)

__all__ = [
    "dp_sharded_bundle_adjust",
    "local_dp_block",
    "initialize_multihost",
    "make_mesh",
    "shard_for_host",
    "sharded_bundle_adjust",
    "sharded_lm_solve",
    "spawn_ranks",
    "window_to_landmark_major",
]
