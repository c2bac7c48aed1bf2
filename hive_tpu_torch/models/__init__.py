"""Models: person segmentation (the motion backend, on the card)."""
