"""State carried across from the JAX package, without importing jax.

The engine has no weights: its state is the config tree, the static tier
tables (the JAX package's module constants, PipelineConfig's defaults
here) and the frames. These helpers give both packages the same inputs:

  * ``config_from_jax`` rebuilds the port's EngineConfig from any dataclass
    tree with the same fields (the JAX package's, through
    ``dataclasses.asdict``), the port's own pipeline capacities
    (``config.PORT_PIPELINE_FIELDS``) at their defaults;
  * ``to_torch`` / ``to_numpy`` convert NamedTuples (nested) of arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .config import EngineConfig


def config_from_jax(cfg: Any) -> EngineConfig:
    """The port's EngineConfig with every field of ``cfg``'s sections."""
    tree = dataclasses.asdict(cfg)
    sections = {}
    for f in dataclasses.fields(EngineConfig):
        section_type = type(getattr(EngineConfig(), f.name))
        sections[f.name] = section_type(**tree[f.name])
    return EngineConfig(**sections)


def to_torch(tree: Any) -> Any:
    """Arrays (numpy, jax, or anything np.asarray takes) -> CPU torch
    tensors, recursing through NamedTuples, tuples and lists; dtypes kept."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_torch(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(x) for x in tree)
    if isinstance(tree, torch.Tensor):
        return tree
    return torch.from_numpy(np.array(tree, copy=True))


def to_numpy(tree: Any) -> Any:
    """torch tensors -> numpy arrays, recursing like ``to_torch``."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(x) for x in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
