from ocean_bgc_tpu_torch.parallel import sharding  # noqa: F401
from ocean_bgc_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    make_sharded_forced_run,
    make_sharded_step,
    shard_world,
)
