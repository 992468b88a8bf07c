"""Hand-written Hopper kernels of the planned query path (``csrc/``), their
plain PyTorch versions (``ref``) and the dispatching wrappers (``ops``)."""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
