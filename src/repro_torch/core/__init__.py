"""FL-DP³S core: data profiling, eq.-(14) similarity kernel, k-DPP selection."""
