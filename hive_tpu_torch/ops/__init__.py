"""Device code: TSDF integration, the refine-query and band-sampler kernels,
isosurface extraction, and the tile-gather, patch-gather and fused band-trip
kernels of the measurement entry points."""
