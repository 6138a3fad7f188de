"""Sampler operations: plain PyTorch pieces, and the wrappers of the CUDA
kernels K1 (:mod:`.fused_step`), K2 (:mod:`.migration`) and K3
(:mod:`.resample_step`)."""

from . import (accept, fused_step, migration, mutation, proposals,
               resample_step)

__all__ = ["accept", "fused_step", "migration", "mutation", "proposals",
           "resample_step"]
