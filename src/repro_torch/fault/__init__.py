"""Deterministic fault injection for the serving + durability layers.

Everything here is seeded: a chaos run with the same seed injects the same
faults at the same points, so a failure reproduces from its seed alone.
``FaultInjector`` drives delays/exceptions at named injection points;
the file-corruption helpers bit-flip or truncate WAL segments for crash
tests; ``repro_torch.fault.chaos`` is the runnable scenario
(``python -m repro_torch.fault.chaos``), which runs on the card unless
``--device cpu`` is given.
"""
from repro_torch.fault.inject import (
    FaultInjector,
    FaultSpec,
    InjectedFault,
    corrupt_byte,
    poison_vector,
    truncate_file,
)

__all__ = [
    "FaultInjector",
    "FaultSpec",
    "InjectedFault",
    "corrupt_byte",
    "poison_vector",
    "truncate_file",
]
