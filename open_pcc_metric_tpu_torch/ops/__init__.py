"""Device operations: Morton grid, pruned 1-NN with the K1 refine kernel,
colour transforms, minimal OBB and the fused pair evaluation.

Exports the JAX package's ``ops`` names, from this package's own modules.
No module imported here builds a kernel: ``_build`` compiles each one at
its first launch on the card.
"""
from .nn import nearest_neighbors, nn_chunked, PRUNE_THRESHOLD
from .knn import knn
# NOTE: nn_pruned / knn_pruned the FUNCTIONS are intentionally not
# re-exported here: their names equal their module names and a re-export
# would rebind ops.nn_pruned from the module to the function. Import them
# from their modules: ``from open_pcc_metric_tpu_torch.ops.nn_pruned import
# nn_pruned``.
from .normals import estimate_normals
from .obb import minimal_obb_extent
from .color import transform_colors, get_color_peak
from .fused import fused_evaluate, pair_stats, finalize_stats

__all__ = [
    "nearest_neighbors",
    "nn_chunked",
    "knn",
    "estimate_normals",
    "minimal_obb_extent",
    "transform_colors",
    "get_color_peak",
    "fused_evaluate",
    "pair_stats",
    "finalize_stats",
    "PRUNE_THRESHOLD",
]
