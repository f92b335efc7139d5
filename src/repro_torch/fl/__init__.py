"""Algorithm 3: the FL round engines, the paper's experiment grid and the
drift-aware closed loop."""
