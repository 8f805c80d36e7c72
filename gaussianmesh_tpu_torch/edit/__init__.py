"""Deformation playback: per-vertex deformation gradients of a mesh sequence,
their barycentric transfer to mesh-bound Gaussians, and the frame loop
(port of `gaussianmesh_tpu/edit/`)."""
