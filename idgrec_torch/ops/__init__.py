"""Operators of the port. Kernel wrappers live beside their plain
PyTorch versions: K1 in `fusedmm`, K3 in `propagate`, K2 (both modes)
in `chainmm`, K4 in `scatter`.
Importing a module builds nothing; kernels build at first use
(`_build`)."""
