"""K4: the Gram product XᵀX; K2: the eq.-(14) normalise-and-Gram kernel;
and the two-launch profiles -> DPP-kernel pipeline built from K1 and K2."""
