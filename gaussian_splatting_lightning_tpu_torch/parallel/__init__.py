"""The mesh: tile bands and view groups over ``torch.distributed``."""

from gaussian_splatting_lightning_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_distributed,
    make_mesh,
    shutdown,
)
from gaussian_splatting_lightning_tpu_torch.parallel.shard import (  # noqa: F401
    batch_cameras,
    make_sharded_train_step,
    sharded_render,
)
