#!/bin/bash
# The PyTorch port's end-to-end pipeline on a generated synthetic scene:
# train_mesh -> render -> metrics -> edit through the port's command lines,
# with the flags of examples/synthetic_e2e.sh (the JAX package's script).
# Nothing here imports JAX: the scene comes from the port alone.
# Usage: GM_DEVICE=cuda|cpu bash examples/synthetic_e2e_torch.sh [workdir]
# GM_E2E_ITERATIONS (default 400, the JAX script's) shortens the training
# for a quick run on the CPU; densification stops at half of it.
set -euo pipefail
cd "$(dirname "$0")/.."
WORK="${1:-gm_e2e_torch}"
DEVICE="${GM_DEVICE:-cuda}"
ITERS="${GM_E2E_ITERATIONS:-400}"
SCENE="$WORK/scene"; MODEL="$WORK/model"
mkdir -p "$WORK"
# each step's start on the wall clock, for a caller that times the steps
mark() { echo "[e2e-step] $1 $(date +%s.%N)"; }

mark make_dataset
# tests/ goes on the path by name: a `tests` package installed elsewhere
# would shadow the repository's
python - "$SCENE" <<'PY'
import sys
sys.path[:0] = [".", "tests"]
from test_torch_e2e import make_dataset
make_dataset(sys.argv[1], n_cams=12)
print("scene written to", sys.argv[1])
PY

mark train_mesh
python -m gaussianmesh_tpu_torch.cli.train_mesh -s "$SCENE" -m "$MODEL" \
    --input_mesh "$SCENE/proxy.obj" --iterations "$ITERS" --init_target 500 \
    --densify_until_iter $((ITERS / 2)) --test_iterations "$ITERS" \
    --save_iterations "$ITERS" \
    --sh_degree 1 --max_per_tile 256 --eval --device "$DEVICE"

mark render
python -m gaussianmesh_tpu_torch.cli.render -m "$MODEL" --iteration "$ITERS" \
    --max_per_tile 256 --device "$DEVICE"
mark metrics
python -m gaussianmesh_tpu_torch.cli.metrics -m "$MODEL" --device "$DEVICE"

mark deformed_mesh
python - "$WORK" <<'PY'
import sys
sys.path[:0] = [".", "tests"]
from meshes import icosphere
from gaussianmesh_tpu_torch.io import mesh as mesh_io
v, f = icosphere(1)
v2 = v.copy(); v2[:, 1] *= 0.5
mesh_io.write_triangle_mesh(sys.argv[1] + "/deformed.obj", v2, f)
PY
mark edit
python -m gaussianmesh_tpu_torch.cli.edit -m "$MODEL" \
    --gaussian_ply "$MODEL/point_cloud/iteration_$ITERS/point_cloud.ply" \
    --origin_mesh "$SCENE/proxy.obj" \
    --deformed_mesh "$WORK/deformed.obj" \
    --out "$WORK/edit_out" --orbit 8 --max_per_tile 256 --device "$DEVICE"
mark end
echo "E2E OK: renders in $MODEL, edit frames in $WORK/edit_out"
