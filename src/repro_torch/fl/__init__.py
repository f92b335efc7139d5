"""Algorithm 3: the FL round engines and the paper's experiment grid."""
