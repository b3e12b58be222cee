"""Generic name -> factory registries (the port's own copy of
``seist_tpu/registry.py``). Registration happens at import time via
decorators."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


class Registry:
    """A simple string-keyed factory registry."""

    def __init__(self, kind: str):
        self._kind = kind
        self._factories: Dict[str, Callable[..., Any]] = {}

    def register(self, fn: Optional[Callable] = None, *, name: Optional[str] = None):
        """Decorator: register ``fn`` under ``name`` (default ``fn.__name__``)."""

        def _do_register(f: Callable) -> Callable:
            key = name or f.__name__
            if key in self._factories:
                raise KeyError(f"{self._kind} '{key}' is already registered.")
            self._factories[key] = f
            return f

        if fn is None:
            return _do_register
        return _do_register(fn)

    def get(self, name: str) -> Callable[..., Any]:
        if name not in self._factories:
            raise KeyError(
                f"Unknown {self._kind}: '{name}'. Registered: {sorted(self._factories)}"
            )
        return self._factories[name]

    def create(self, name: str, **kwargs) -> Any:
        return self.get(name)(**kwargs)

    def names(self) -> List[str]:
        return sorted(self._factories)

    def __contains__(self, name: str) -> bool:
        return name in self._factories

    def __len__(self) -> int:
        return len(self._factories)


# Populated by importing seist_tpu_torch.models / seist_tpu_torch.data.
MODELS = Registry("model")
DATASETS = Registry("dataset")


def register_model(fn=None, *, name: Optional[str] = None):
    return MODELS.register(fn, name=name)


def register_dataset(fn=None, *, name: Optional[str] = None):
    return DATASETS.register(fn, name=name)
