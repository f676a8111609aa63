from gftorf_tpu_torch.render.settings import CameraSpec, RasterConfig, RenderOutputs
from gftorf_tpu_torch.render.rasterize import rasterize
