"""PyTorch + CUDA port of the UDG interval-predicate ANN system.

A second package beside the JAX reference ``repro``, with the same module
layout (``core``, ``data``, ``configs``, ``kernels``, ``search``, ``exec``).
It imports torch and numpy and nothing of ``repro`` or ``jax``. The planned
query path runs on the card through hand-written Hopper kernels
(``kernels/csrc``); on CPU tensors each kernel wrapper takes its plain
PyTorch version instead.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
