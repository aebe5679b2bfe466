"""ponyc_tpu_torch — the PyTorch/CUDA port of the ponyc_tpu actor framework.

The JAX package ``ponyc_tpu`` is the reference; this package keeps its
module layout and names and runs the same programs with PyTorch on an
NVIDIA GPU (the CPU when asked: ``Runtime(opts, device="cpu")``). It
imports torch, numpy and the standard library only. Kernels written by
hand for Hopper live under ``csrc/`` and are built on first use
(ops/_build.py). ROADMAP.md lists what this slice serves and which slice
brings the rest.
"""

from .api import (Actor, Blob, BlobVal, Bool, Box, Context, F32, I8, I16,
                  I32, Iso, Mut, Ref, Tag, Trn, TypeParam, U8, U16, U32,
                  Val, VecF32, VecI32, actor, be, behaviour)
from .config import RuntimeOptions, options_from_env, strip_runtime_flags
from .program import Program
from .runtime.runtime import (BlobCapacityError, Runtime,
                              SpawnCapacityError, SpillOverflowError)

__version__ = "0.1.0"

__all__ = [
    "Actor", "Blob", "BlobVal", "Bool", "Box", "Context", "F32", "I8",
    "I16", "I32", "Iso", "Mut", "Ref", "Tag", "Trn", "TypeParam", "U8",
    "U16", "U32", "Val", "VecF32", "VecI32", "actor", "be", "behaviour",
    "RuntimeOptions", "options_from_env", "strip_runtime_flags", "Program",
    "Runtime", "SpillOverflowError", "SpawnCapacityError",
    "BlobCapacityError",
]
