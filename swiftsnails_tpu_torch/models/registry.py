"""Model registry: name -> Trainer class (the JAX package's ``models/registry.py``).

The reference selects its app by shipping per-app binaries
(``src/tools/copy_exec.sh``); here the ``model`` config key selects the
trainer.
"""

from __future__ import annotations

from typing import Callable, Dict, Type

from swiftsnails_tpu_torch.framework.trainer import Trainer

_REGISTRY: Dict[str, Type[Trainer]] = {}


def register_model(name: str) -> Callable[[Type[Trainer]], Type[Trainer]]:
    def deco(cls: Type[Trainer]) -> Type[Trainer]:
        _REGISTRY[name] = cls
        return cls

    return deco


def get_model(name: str) -> Type[Trainer]:
    # import model modules lazily so registration happens on first use
    import swiftsnails_tpu_torch.models  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_models():
    import swiftsnails_tpu_torch.models  # noqa: F401

    return sorted(_REGISTRY)
