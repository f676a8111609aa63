from gftorf_tpu_torch.parallel.mesh import make_mesh
from gftorf_tpu_torch.parallel.sharded import rasterize_sharded
