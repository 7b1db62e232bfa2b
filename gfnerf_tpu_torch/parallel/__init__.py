"""Multi-card training over ``torch.distributed`` (port of
``gfnerf_tpu/parallel``): the collectives (:mod:`.comm`), the rank grid and
the multi-card train steps (:mod:`.sharding`)."""

from gfnerf_tpu_torch.parallel.comm import (Comm, initialize_multihost,
                                            shutdown, world)
from gfnerf_tpu_torch.parallel.sharding import (RankGrid, block_axis,
                                                block_optimizer,
                                                make_dp_train_step, make_grid,
                                                make_parallel_block_step,
                                                multihost_grid, state_digest)

__all__ = ["Comm", "RankGrid", "block_axis", "block_optimizer",
           "initialize_multihost",
           "make_dp_train_step", "make_grid", "make_parallel_block_step",
           "multihost_grid", "shutdown", "state_digest", "world"]
