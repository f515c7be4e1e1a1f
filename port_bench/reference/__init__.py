"""The plain reference the benchmark judges the port's answers by: the
generators it draws its inputs from, its own reading of those files, the
cost in residual form, the certificate's inertia, and a plain
trust-region solve.  It imports numpy, scipy and torch, nothing of the
port and nothing of JAX."""
