"""LM substrate: decoder stacks for every assigned architecture family
(dense GQA, local:global, Mamba1/Mamba2 SSM, fine-grained MoE, hybrid
shared-attention, VLM/audio token backbones), their train step (loss,
gradients with ``cfg.remat``'s checkpointing, the optimizer's update), their
prefill and decode steps with caches, and ``params_from_numpy`` /
``params_to_numpy`` to carry the JAX package's parameters across.

The layers take ``tp``, the model group a tensor-parallel step splits their
work over, and reach its collectives through ``distributed.comm`` (which
imports nothing of the port): the one dependency of this package on
``distributed``, whose sharded steps import it in turn."""
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.model import LM, forward, init_params, init_params_shapes, param_count
from repro_torch.models.steps import (
    decode_step,
    init_decode_state,
    loss_fn,
    make_train_step,
    prefill_step,
    softmax_xent,
)

__all__ = [
    "LM",
    "decode_step",
    "forward",
    "init_decode_state",
    "init_params",
    "init_params_shapes",
    "loss_fn",
    "make_train_step",
    "param_count",
    "params_from_numpy",
    "params_to_numpy",
    "prefill_step",
    "softmax_xent",
]
