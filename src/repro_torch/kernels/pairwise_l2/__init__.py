"""K1: pairwise L2 distances with the eq.-(14) sqrt epilogue and min/max
stats; K3: clamped squared L2 distances (the stage-wise route)."""
