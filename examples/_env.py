"""Example environment setup: default to CPU (the demos are small and
host-driven). Set BULLET_BACKEND=gpu to run them on the GPU instead.

Import this before anything that imports jax. Also puts the repo root on
sys.path so ``python examples/<any>_example.py`` works from any cwd
without installing the package.
"""

import os
import sys

_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _root not in sys.path:
    sys.path.insert(0, _root)

if os.environ.get("BULLET_BACKEND", "cpu").lower() != "gpu":
    import jax

    jax.config.update("jax_platforms", "cpu")
