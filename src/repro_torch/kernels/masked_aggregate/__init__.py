"""masked_aggregate: the eq.-4 server sum."""
