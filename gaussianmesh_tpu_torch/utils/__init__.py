from gaussianmesh_tpu_torch.utils import graphics, lr, maths, sh, subdivision  # noqa: F401
