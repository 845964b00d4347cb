from megaverse_tpu_torch.parallel.distributed import (  # noqa: F401
    maybe_initialize_distributed,
    shutdown_distributed,
    spawn,
    world,
)
from megaverse_tpu_torch.parallel.mesh import ParallelLearner, rank_seed  # noqa: F401
