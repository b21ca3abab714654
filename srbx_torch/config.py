"""The configuration dataclasses, shared with the JAX package.

`srbx.config` is pure Python (neither it nor `srbx/__init__.py` imports
jax), so both packages read one definition of every setting. This module is
the port's only import from `srbx`.
"""

from srbx.config import LipConfig, MpcConfig, QpConfig, RefPlanConfig

__all__ = ["LipConfig", "MpcConfig", "QpConfig", "RefPlanConfig"]
