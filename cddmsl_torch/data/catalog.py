"""Dataset and metadata catalogs (the port's copy of
cddmsl_tpu/data/catalog.py): `DatasetCatalog.register(name, fn)` /
`.get(name)` returning list[dict], and `MetadataCatalog.get(name)` returning
an attribute bag. Both catalogs can drop a name (`remove`), so a caller that
registers a dataset can take it out again.
"""

from typing import Any, Callable, Dict, List


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, func: Callable[[], List[dict]]) -> None:
        if name in self._registry:
            raise ValueError(f"Dataset '{name}' is already registered!")
        if not callable(func):
            raise TypeError("You must register a callable!")
        self._registry[name] = func

    def get(self, name: str) -> List[dict]:
        try:
            f = self._registry[name]
        except KeyError:
            raise KeyError(
                f"Dataset '{name}' is not registered! Available: {sorted(self._registry)[:50]}"
            )
        return f()

    def list(self) -> List[str]:
        return sorted(self._registry)

    def remove(self, name: str) -> None:
        del self._registry[name]

    def __contains__(self, name: str) -> bool:
        return name in self._registry


class Metadata:
    def __init__(self, name: str):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "_data", {})

    def __getattr__(self, key: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if key in data:
            return data[key]
        raise AttributeError(f"Metadata '{self.name}' has no attribute '{key}'")

    def __setattr__(self, key: str, value: Any) -> None:
        data = object.__getattribute__(self, "_data")
        if key in data and data[key] != value:
            raise ValueError(f"Metadata '{self.name}.{key}' cannot be overwritten")
        data[key] = value

    def set(self, **kwargs: Any) -> "Metadata":
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def get(self, key: str, default: Any = None) -> Any:
        return object.__getattribute__(self, "_data").get(key, default)

    def as_dict(self) -> Dict[str, Any]:
        return dict(object.__getattribute__(self, "_data"))


class _MetadataCatalog:
    def __init__(self):
        self._registry: Dict[str, Metadata] = {}

    def get(self, name: str) -> Metadata:
        if name not in self._registry:
            self._registry[name] = Metadata(name)
        return self._registry[name]

    def list(self) -> List[str]:
        return sorted(self._registry)

    def remove(self, name: str) -> None:
        self._registry.pop(name, None)


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
