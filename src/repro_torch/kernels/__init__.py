"""The NIC kernels of the data plane: hand-written CUDA C++ for Hopper
(``csrc/``), each beside its plain PyTorch version; ``ops`` dispatches by
the tensors' device."""
