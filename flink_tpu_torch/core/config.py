"""Configuration: the keys the port reads (subset of
``flink_tpu/core/config.py``).

``Configuration`` is a string-keyed map that accepts only the keys
some part of the port reads; setting any other key raises, so a key
carried over from a JAX job is never dropped silently.  Each key is a
``ConfigOption`` on one of the option groups below, with the
reference's default and description (``core/config_docs.py`` renders
them).  The keys:

======================================  ================================
``state.backend``                       keyed-state backend name
                                        (``state/loader.py``)
``state.backend.tpu.max-device-slots``  device-slot budget per state;
                                        beyond it cold slots spill to
                                        host RAM
``state.backend.tpu.microbatch-size``   pending-ring flush size
``metrics.sample.interval.ms``          the metrics journal's cadence
                                        (unset: no journal)
``metrics.history.size``                samples kept per metric
                                        (default 1024)
``lint.mode``                           the pre-flight graph lint at
                                        ``execute`` (default ``warn``)
``lint.types.mode``                     the column type-flow prover at
                                        ``execute`` (default ``off``)
======================================  ================================
"""

from __future__ import annotations

from typing import Any, Optional


class ConfigOption:
    """A typed option: key, default, description (ref
    ``flink_tpu/core/config.py:19-52``)."""

    __slots__ = ("key", "default", "description", "value_type")

    def __init__(self, key: str, default: Any = None, description: str = "",
                 value_type: Optional[type] = None):
        self.key = key
        self.default = default
        self.description = description
        self.value_type = value_type if value_type is not None else (
            type(default) if default is not None else None)

    def has_default(self) -> bool:
        return self.default is not None

    def __repr__(self) -> str:
        return f"ConfigOption(key={self.key!r}, default={self.default!r})"


class CheckpointingOptions:
    STATE_BACKEND = ConfigOption("state.backend", "heap", value_type=str)


class StateBackendOptions:
    """Keyed-state backend tuning under ``state.backend.*``
    (``state/loader.py`` rejects non-positive values)."""

    TPU_MAX_DEVICE_SLOTS = ConfigOption(
        "state.backend.tpu.max-device-slots", value_type=int,
        description="Per-state HBM slot budget for the TPU backend; beyond "
        "it the LRU-coldest slots spill to host RAM and are promoted back "
        "on access. Unset = uncapped (grow-doubling device tables).")
    TPU_MICROBATCH_SIZE = ConfigOption(
        "state.backend.tpu.microbatch-size", value_type=int,
        description="Pending-ring flush threshold for the TPU backend's "
        "device scatter/gather: state writes buffer on host and flush to "
        "the device in one fused scatter once this many rows are pending. "
        "Unset = the backend's built-in default (16384).")


class MetricOptions:
    """The metrics keys (ref ``flink_tpu/core/config.py:333-343``)."""

    #: time-series journal (``runtime/timeseries.py``): off unless set
    SAMPLE_INTERVAL_MS = ConfigOption("metrics.sample.interval.ms",
                                      value_type=int)
    HISTORY_SIZE = ConfigOption("metrics.history.size", 1024, value_type=int)


class LintOptions:
    """The pre-flight gates ``execute`` reads.  Both take ``off`` |
    ``warn`` | ``strict``, checked by :func:`lint_mode_of`."""

    MODE = ConfigOption(
        "lint.mode", "warn", value_type=str,
        description="Pre-flight graph lint at execute(): off = skip, warn "
        "= log errors/warnings and run anyway, strict = raise "
        "JobValidationError on any ERROR diagnostic.")
    TYPES_MODE = ConfigOption(
        "lint.types.mode", "off", value_type=str,
        description="Column type-flow prover (pass 3) at execute(): off = "
        "skip, warn = run it, log FT185-FT188 findings, and feed "
        "conclusive verdicts into the runtime (probe-free kernels, codec "
        "hints, state pre-sizing), strict = additionally raise "
        "JobValidationError when any FT185-FT188 finding fires.")


#: the only values the lint gates accept
LINT_MODES = ("off", "warn", "strict")

#: every key the port reads
KNOWN_KEYS = frozenset(o.key for o in (
    CheckpointingOptions.STATE_BACKEND,
    StateBackendOptions.TPU_MAX_DEVICE_SLOTS,
    StateBackendOptions.TPU_MICROBATCH_SIZE,
    MetricOptions.SAMPLE_INTERVAL_MS,
    MetricOptions.HISTORY_SIZE,
    LintOptions.MODE,
    LintOptions.TYPES_MODE,
))


def _key(option) -> str:
    return option.key if isinstance(option, ConfigOption) else option


def lint_mode_of(config, option: ConfigOption) -> str:
    """One lint gate's value, checked: an unknown value raises with the
    accepted names instead of leaving a gate someone meant to arm off."""
    mode = str(config.get(option)).lower().strip()
    if mode not in LINT_MODES:
        raise ValueError(
            f"unknown {option.key} value {mode!r}; expected one of "
            f"{sorted(LINT_MODES)}")
    return mode


class Configuration:
    def __init__(self, data: Optional[dict] = None):
        self._data: dict = {}
        for key, value in (data or {}).items():
            self.set(key, value)

    def set(self, key, value: Any) -> "Configuration":
        """``key``: a key string or a ``ConfigOption``."""
        key = _key(key)
        if key not in KNOWN_KEYS:
            raise KeyError(f"configuration key {key!r} is not read by the "
                           f"port; it reads {sorted(KNOWN_KEYS)}")
        self._data[key] = value
        return self

    def contains(self, key) -> bool:
        return _key(key) in self._data

    def get(self, key, default: Any = None) -> Any:
        """The value set, else ``default``, else the option's default."""
        if isinstance(key, ConfigOption):
            if key.key in self._data:
                return self._data[key.key]
            return key.default if default is None else default
        return self._data.get(key, default)

    def get_string(self, key, default: Optional[str] = None) -> Optional[str]:
        v = self.get(key, default)
        return None if v is None else str(v)

    def get_integer(self, key, default: Optional[int] = None) -> Optional[int]:
        v = self.get(key, default)
        return None if v is None else int(v)

    def __repr__(self):
        return f"Configuration({self._data!r})"
