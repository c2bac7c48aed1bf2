"""Dataset-format readers and writers: COLMAP sparse models and dense depth
maps, and the LLFF and HyperNeRF captures of the render-vs-photo evaluation."""
