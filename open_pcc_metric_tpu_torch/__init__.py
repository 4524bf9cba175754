"""open_pcc_metric_tpu_torch — the PyTorch/CUDA port of open_pcc_metric_tpu.

MPEG pc_error-style D1/D2/Hausdorff/colour metrics for point-cloud
compression, evaluated on a torch device: a Morton chunk grid and a
certificate-pruned exact 1-NN search whose refine step is a hand-written
CUDA kernel (``csrc/refine_nn.cu``) on the GPU and plain PyTorch on the CPU.
The JAX package ``open_pcc_metric_tpu`` is the reference it is tested
against; this package never imports it or JAX.
"""
from .cloud import Cloud, synthetic_sphere_pair, synthetic_voxel_pair
from .calculator import CalculateResult
from .options import CalculateOptions, transform_options
from .evaluate import evaluate_files, evaluate_pair, load_cloud
from .io import read_point_cloud, write_ply

__version__ = "0.1.0"

__all__ = [
    "Cloud",
    "CalculateOptions",
    "CalculateResult",
    "transform_options",
    "evaluate_files",
    "evaluate_pair",
    "load_cloud",
    "read_point_cloud",
    "write_ply",
    "synthetic_sphere_pair",
    "synthetic_voxel_pair",
    "__version__",
]
