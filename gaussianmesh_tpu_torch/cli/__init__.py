"""Command-line entry points (`python -m gaussianmesh_tpu_torch.cli.<name>`)."""
