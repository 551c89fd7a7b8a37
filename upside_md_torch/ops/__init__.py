"""Tensor operations of the port: plain PyTorch math and the Hopper kernels
(each kernel wrapper sits beside its plain version)."""
