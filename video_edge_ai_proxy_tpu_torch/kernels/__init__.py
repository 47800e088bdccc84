"""Hand-written CUDA kernels of the port and their launch wrappers.

Each wrapper takes CUDA tensors only, checks them, launches its kernel on
PyTorch's current stream and counts the launch in its ``launches``
attribute. The plain PyTorch version of each kernel lives beside its
caller in ``ops/``.
"""
