"""Sampler operations: plain PyTorch pieces, and the wrappers of the CUDA
kernels K1 (:mod:`.fused_step`) and K2 (:mod:`.migration`)."""

from . import accept, fused_step, migration, mutation, proposals

__all__ = ["accept", "fused_step", "migration", "mutation", "proposals"]
