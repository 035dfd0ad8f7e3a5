"""Model substrate: the paper's CNN."""
