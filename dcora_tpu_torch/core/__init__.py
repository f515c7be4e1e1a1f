"""Engine: lifted state, manifold, problem, tiles, SpMM, RTR, certification."""
