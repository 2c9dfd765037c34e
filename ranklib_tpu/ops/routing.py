"""Implementation routing: the one place that picks a device path.

Every entry selects on what the code can observe — the JAX platform
(``gpu`` or ``cpu``) and the operand shapes — never on a user switch.
Callers ask at trace time; a process's default backend never changes,
so neither does the answer for a given shape.

| decision         | gpu                                 | cpu          |
|------------------|-------------------------------------|--------------|
| ensemble scoring | Triton kernel when the trees fit    | ``_mm_eval`` |
| predicate dtype  | bf16 (0/1 and {-1, 0, 1} are exact) | f32          |

The feature histogram (``ops/histogram.py``) and the split scan
(``ops/split_scan.py``) have one implementation each: XLA's fusion of
the plain form beat the kernels written for them on the H100.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Widest (padded) per-chunk node or leaf count the scoring kernel holds
# on chip; deeper trees score through the XLA path.
SCORE_KERNEL_MAX_WIDTH = 128


def platform() -> str:
    """The default JAX backend: ``gpu`` on the card, ``cpu`` otherwise."""
    return jax.default_backend()


def scoring_kernel(max_nodes: int, max_leaves: int) -> bool:
    """The Triton scorer keeps one tree chunk's [nodes, leaves] path
    matrix on chip; a tree wider than that takes ``_mm_eval``."""
    return platform() == "gpu" and max(int(max_nodes), int(max_leaves)) <= (
        SCORE_KERNEL_MAX_WIDTH)


def predicate_dtype():
    """dtype of the 0/1 predicate and {-1, 0, 1} path operands of
    ``_mm_eval``: exact in bf16, which halves their traffic. The CPU
    keeps f32, where bf16 dots are emulated."""
    return jnp.float32 if platform() == "cpu" else jnp.bfloat16
