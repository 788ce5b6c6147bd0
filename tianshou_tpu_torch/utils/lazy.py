"""A package's public names imported from their modules on first use: the
subpackages' modules import one another, so a package that imported them
all itself would import in a cycle."""

import importlib
from collections.abc import Callable

__all__ = ["lazy_exports"]


def lazy_exports(package: str, exports: dict[str, str]) -> Callable[[str], object]:
    """The module ``__getattr__`` of ``package``: a name of ``exports`` is
    imported from the module ``package.<exports[name]>``."""

    def __getattr__(name: str):
        if name in exports:
            return getattr(importlib.import_module(f"{package}.{exports[name]}"), name)
        raise AttributeError(f"module {package!r} has no attribute {name!r}")

    return __getattr__
