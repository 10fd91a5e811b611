"""Configuration: the keys the port reads (subset of
``flink_tpu/core/config.py``).

``Configuration`` is a string-keyed map that accepts only the keys
some part of the port reads; setting any other key raises, so a key
carried over from a JAX job is never dropped silently.  The keys:

======================================  ================================
``state.backend``                       keyed-state backend name
                                        (``state/loader.py``)
``state.backend.tpu.max-device-slots``  device-slot budget per state;
                                        beyond it cold slots spill to
                                        host RAM
``state.backend.tpu.microbatch-size``   pending-ring flush size
======================================  ================================
"""

from __future__ import annotations

from typing import Any, Optional

#: every key the port reads
KNOWN_KEYS = frozenset({
    "state.backend",
    "state.backend.tpu.max-device-slots",
    "state.backend.tpu.microbatch-size",
})


class Configuration:
    def __init__(self, data: Optional[dict] = None):
        self._data: dict = {}
        for key, value in (data or {}).items():
            self.set(key, value)

    def set(self, key: str, value: Any) -> "Configuration":
        if key not in KNOWN_KEYS:
            raise KeyError(f"configuration key {key!r} is not read by the "
                           f"port; it reads {sorted(KNOWN_KEYS)}")
        self._data[key] = value
        return self

    def contains(self, key: str) -> bool:
        return key in self._data

    def get_string(self, key: str, default: Optional[str] = None) -> Optional[str]:
        v = self._data.get(key, default)
        return None if v is None else str(v)

    def get_integer(self, key: str, default: Optional[int] = None) -> Optional[int]:
        v = self._data.get(key, default)
        return None if v is None else int(v)

    def __repr__(self):
        return f"Configuration({self._data!r})"
