"""Kernel registry: uniform discovery of the port's kernel ops.

Every ``kernels/<name>/ops.py`` registers a :class:`KernelSpec` describing
its public entry point and which engine query modes it serves; the engine's
device backend routes through :func:`get` instead of importing kernel
modules directly.  Specs are registered at ops-module import; :func:`get`
imports the module lazily on first use, so constructing an engine never
pays kernel import cost (and nothing is compiled before a launch).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Callable

from .build import SOURCES

# kernel name -> module that registers it (lazy import target)
_OPS_MODULES = {name: f"repro_torch.kernels.{name}.ops" for name in SOURCES}

_REGISTRY: dict[str, "KernelSpec"] = {}


@dataclass(frozen=True)
class KernelSpec:
    """One registered kernel entry point; ``modes`` names the engine query
    modes the op serves."""

    name: str
    fn: Callable
    modes: tuple[str, ...] = ()
    description: str = ""


def register(spec: KernelSpec) -> KernelSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> KernelSpec:
    """Spec for ``name``, importing its ops module on first use."""
    if name not in _REGISTRY:
        mod = _OPS_MODULES.get(name)
        if mod is None:
            raise KeyError(f"unknown kernel {name!r}; "
                           f"known: {sorted(_OPS_MODULES)}")
        importlib.import_module(mod)
    return _REGISTRY[name]


def default_interpret() -> bool:
    """True when no CUDA device can run the kernels, so a caller must keep
    its tensors on the CPU, where the ops run their plain versions."""
    import torch
    return not torch.cuda.is_available()
