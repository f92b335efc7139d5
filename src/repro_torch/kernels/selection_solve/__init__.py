"""selection_solve: the per-element solves of problem (7)."""
