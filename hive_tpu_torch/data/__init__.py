"""Dataset-format readers and writers: COLMAP sparse models and dense depth maps."""
