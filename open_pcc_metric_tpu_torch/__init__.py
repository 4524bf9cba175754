"""open_pcc_metric_tpu_torch — the PyTorch/CUDA port of open_pcc_metric_tpu.

MPEG pc_error-style D1/D2/Hausdorff/colour metrics for point-cloud
compression, evaluated on a torch device (the CUDA device unless the
caller names another): exact 1-NN searches — brute force for small clouds,
a Morton chunk grid with certificate pruning for large ones — and 30-NN PCA
normals, whose inner loops are hand-written CUDA kernels (``csrc/*.cu``) on
the GPU and plain PyTorch on the CPU. Two engines give the same table: the
fused evaluation and the reference-shaped lazy metric DAG
(``CloudPair`` -> ``MetricCalculator``). The JAX package
``open_pcc_metric_tpu`` is the reference it is tested against; this
package never imports it or JAX.
"""
from .cloud import Cloud, synthetic_sphere_pair, synthetic_voxel_pair
from .cloud_pair import CloudPair, get_neighbour_cloud
from .calculator import CalculateResult, MetricCalculator
from .options import CalculateOptions, transform_options
from .evaluate import evaluate_files, evaluate_pair, load_cloud
from .io import read_point_cloud, write_ply

__version__ = "0.1.0"

__all__ = [
    "Cloud",
    "CloudPair",
    "get_neighbour_cloud",
    "MetricCalculator",
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
