"""Sampler operations: plain PyTorch pieces, and the wrappers of the CUDA
kernels K1 (:mod:`.fused_step`), K2 (:mod:`.migration`), K3
(:mod:`.resample_step`) and K4 (:mod:`.kde`)."""

from . import (accept, fused_step, kde, migration, mutation, proposals,
               resample_step)

__all__ = ["accept", "fused_step", "kde", "migration", "mutation",
           "proposals", "resample_step"]
