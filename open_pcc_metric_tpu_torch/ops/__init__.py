"""Device operations: Morton grid, pruned 1-NN with the K1 refine kernel,
colour transforms, minimal OBB and the fused pair evaluation."""
