"""Host utilities: the rung-ladder memo and stderr logging.

Exports the JAX package's ``utils`` names but ``enable_compile_cache``,
which has no counterpart here: PyTorch runs eagerly and compiles no
program to cache, and each CUDA kernel's build is cached by
``ops/_build.py`` under ``build/torch_kernels/``.
"""
from .cache import ladder_lookup, ladder_store, next_rung
from .logging import get_logger

__all__ = ["get_logger", "ladder_lookup", "ladder_store", "next_rung"]
