from gaussianmesh_tpu_torch.utils import graphics, maths, sh, subdivision  # noqa: F401
