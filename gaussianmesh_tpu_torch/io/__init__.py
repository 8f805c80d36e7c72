from gaussianmesh_tpu_torch.io import gaussian_ply, mesh, ply  # noqa: F401
