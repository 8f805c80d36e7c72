"""Offline evaluation: PSNR, SSIM and LPIPS over rendered views (port of
`gaussianmesh_tpu/eval/`)."""
