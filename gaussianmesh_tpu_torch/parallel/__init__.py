"""Multi-process regimes on `torch.distributed` (port of `gaussianmesh_tpu/parallel/`)."""
