"""Meili on PyTorch and CUDA: the port of the JAX package ``repro``.

The package mirrors the reference layout (``core/``, ``kernels/``,
``apps/``) and imports neither JAX nor anything of ``repro``. Entry points
take ``device=`` and default to ``"cuda"``; pass ``device="cpu"`` to run
the plain PyTorch paths on a machine without a GPU. The NIC kernels are
hand-written CUDA C++ for ``sm_90a`` (``kernels/csrc``), built with ``nvcc``
at first use.
"""
