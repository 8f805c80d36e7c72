from gaussianmesh_tpu_torch.models import gaussians, mesh_gaussians, render  # noqa: F401
