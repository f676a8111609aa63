from gftorf_tpu_torch.models.gaussians import (
    GaussianParams,
    GaussianAux,
    AdamState,
    GaussianModelState,
)
from gftorf_tpu_torch.models.deform import DeformParams, init_deform, apply_deform
