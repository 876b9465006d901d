"""String-keyed registries for YAML-driven instantiation.

The port's own copy of `vmambair_tpu/utils/registry.py` (the port imports
nothing of the JAX package): YAML `type:` fields name classes and
factories registered here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def register(self, obj: Any = None, name: str | None = None):
        if obj is None:
            return lambda o: self.register(o, name)
        key = name or obj.__name__
        if key in self._obj_map:
            raise KeyError(f"{key} already registered in {self._name}")
        self._obj_map[key] = obj
        return obj

    def get(self, name: str) -> Any:
        if name not in self._obj_map:
            raise KeyError(
                f"'{name}' not found in registry '{self._name}'. "
                f"Available: {sorted(self._obj_map)}"
            )
        return self._obj_map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def keys(self):
        return self._obj_map.keys()


ARCH_REGISTRY = Registry("arch")
MODEL_REGISTRY = Registry("model")
DATASET_REGISTRY = Registry("dataset")
LOSS_REGISTRY = Registry("loss")
METRIC_REGISTRY = Registry("metric")


def build_from_cfg(cfg: dict, registry: Registry, **extra):
    """Instantiate `registry[cfg['type']](**cfg-without-type, **extra)`."""
    cfg = dict(cfg)
    obj_type = cfg.pop("type")
    cls = registry.get(obj_type)
    return cls(**cfg, **extra)
