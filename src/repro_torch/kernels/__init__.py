"""The port's decode kernels: hand-written CUDA (``csrc/``), their
ctypes build (``build``), public wrappers (``ops``) and plain PyTorch
versions (``ref``)."""
from repro_torch.kernels import ops, ref  # noqa: F401
