"""JSON serde for configuration dataclasses.

The reference serializes its config tree with Jackson polymorphic typing
(``@class`` keys; reference nn/conf/NeuralNetConfiguration.java mapper setup,
MultiLayerConfiguration.fromJson). Here every config dataclass registers under
a stable type name; ``to_jsonable``/``from_jsonable`` walk the tree. Configs
are the serialization format for checkpoints, so this must stay stable.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Type

_TYPE_REGISTRY: Dict[str, Type] = {}


def register_config(cls=None, *, name: str = None):
    """Class decorator: register a dataclass for polymorphic JSON serde."""
    def wrap(c):
        key = name or c.__name__
        _TYPE_REGISTRY[key] = c
        c._serde_name = key
        return c
    return wrap(cls) if cls is not None else wrap


def to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        d = {"@type": getattr(obj, "_serde_name", obj.__class__.__name__)}
        for f in dataclasses.fields(obj):
            if f.metadata.get("transient"):
                continue
            d[f.name] = to_jsonable(getattr(obj, f.name))
        return d
    if isinstance(obj, dict):
        return {k: to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    return obj


def from_jsonable(data: Any) -> Any:
    if isinstance(data, dict):
        if "@type" in data:
            cls = _TYPE_REGISTRY.get(data["@type"])
            if cls is None:
                raise ValueError(f"Unknown config type '{data['@type']}'; "
                                 f"known: {sorted(_TYPE_REGISTRY)}")
            kwargs = {k: from_jsonable(v) for k, v in data.items()
                      if k != "@type"}
            field_names = {f.name for f in dataclasses.fields(cls)}
            kwargs = {k: v for k, v in kwargs.items() if k in field_names}
            obj = cls(**kwargs)
            return obj
        return {k: from_jsonable(v) for k, v in data.items()}
    if isinstance(data, list):
        return [from_jsonable(v) for v in data]
    return data
