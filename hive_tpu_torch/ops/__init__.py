"""Device code: TSDF integration, the refine-query and band-sampler kernels,
isosurface extraction."""
