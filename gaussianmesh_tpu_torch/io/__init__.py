from gaussianmesh_tpu_torch.io import gaussian_ply, ply  # noqa: F401
