from gaussianmesh_tpu_torch.ops import (  # noqa: F401
    binning,
    oracle,
    preprocess,
    rasterize,
    segsum,
    tile_blend,
)
