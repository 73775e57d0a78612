"""Format registry: name -> data source implementation.

Copy of ``tpu_tfrecord/registry.py``: the equivalent of Spark's
ServiceLoader-based DataSourceRegister
(reference META-INF/services file + DefaultSource.shortName at
DefaultSource.scala:23-24; SURVEY.md §2.10/§3.4): a process-local registry
keyed by short format name, populated at import time by the io layer.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Any] = {}


def register_format(short_name: str, factory: Callable[[], Any]) -> None:
    """Register a data-source factory under a short name (e.g. 'tfrecord')."""
    _REGISTRY[short_name.lower()] = factory


def lookup_format(short_name: str) -> Any:
    """Resolve a short name to a data-source instance, like Spark resolving
    ``format("tfrecord")``; unknown names raise."""
    key = short_name.lower()
    if key not in _REGISTRY:
        # Importing the io layer registers the built-in 'tfrecord' format,
        # mirroring the lazy ServiceLoader resolution.
        if key == "tfrecord":
            import tpu_tfrecord_torch.io  # noqa: F401  (registers on import)
        if key not in _REGISTRY:
            raise ValueError(
                f"Unknown data source format {short_name!r}; "
                f"registered: {sorted(_REGISTRY)}"
            )
    return _REGISTRY[key]()
