"""The splat store, PLY interchange and ``.splat`` export."""

from gaussian_splatting_lightning_tpu_torch.models.gaussians import (  # noqa: F401
    DEAD_OPACITY_LOGIT,
    PARAM_NAMES,
    GaussianParams,
    GaussianScene,
    from_colmap_points_ply,
    from_points,
    load_ply,
    save_ply,
)
from gaussian_splatting_lightning_tpu_torch.models.splat_export import (  # noqa: F401
    save_splat,
    scene_to_splat_bytes,
)
