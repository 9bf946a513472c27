"""Operators of the port. Kernel wrappers live beside their plain
PyTorch versions: K1, K5 (the transposed duals) and K6, K7, K8 (the
per-application duals) in `fusedmm`, K3 in `propagate`, K2 (both modes)
in `chainmm`, K4 in `scatter`; `spmm` is the gather backend's sparse
product on stock PyTorch operations.
Importing a module builds nothing; kernels build at first use
(`_build`)."""
