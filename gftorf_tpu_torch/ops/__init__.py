from gftorf_tpu_torch.ops.sh import (
    SH_C0,
    eval_sh,
    num_sh_coeffs,
    rgb2sh,
    sh2rgb,
    pa2sh,
    sh2pa,
)
from gftorf_tpu_torch.ops.transforms import (
    world_to_view,
    projection_matrix,
    projection_matrix_shift,
    full_projection,
    camera_center,
    fov2focal,
    focal2fov,
    ndc2pix,
)
from gftorf_tpu_torch.ops.covariance import (
    quat_to_rotmat,
    build_cov3d,
    ewa_project_cov2d,
    conic_from_cov2d,
)
from gftorf_tpu_torch.ops.tof import (
    depth_from_tof,
    tof_from_depth,
    phasor_channels,
    dist_to_phase_scale,
)
from gftorf_tpu_torch.ops.knn import mean_knn_sq_dist
