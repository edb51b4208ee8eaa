"""The port's kernels: the NIC kernels of the data plane and the attention
kernels of LM serving, hand-written CUDA C++ for Hopper (``csrc/``), each
beside its plain PyTorch version; ``ops`` dispatches by the tensors'
device."""
