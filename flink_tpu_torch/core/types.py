"""Type information and extraction (port of ``flink_tpu/core/types.py``).

``TypeInformation`` names a type and creates its serializer; ``Types``
holds the standard instances and the composite constructors;
``type_info_of`` infers a type from a sample value, recursing through
tuples, lists and dicts, and anything it does not know is the pickled
generic type.
"""


from __future__ import annotations

from typing import Any, List

import numpy as np

from flink_tpu_torch.core.serialization import (
    BooleanSerializer,
    BytesSerializer,
    DoubleSerializer,
    IntSerializer,
    ListSerializer,
    LongSerializer,
    MapSerializer,
    NumpyArraySerializer,
    PickleSerializer,
    StringSerializer,
    TupleSerializer,
    TypeSerializer,
)


class TypeInformation:
    """(ref: TypeInformation.java) — a named type descriptor that
    creates its serializer."""

    def __init__(self, name: str, serializer: TypeSerializer,
                 arity: int = 1, is_basic: bool = True):
        self.name = name
        self._serializer = serializer
        self.arity = arity
        self.is_basic_type = is_basic

    def create_serializer(self) -> TypeSerializer:
        return self._serializer

    @property
    def serializer(self) -> TypeSerializer:
        return self._serializer

    def __repr__(self):
        return f"TypeInformation({self.name})"

    def __eq__(self, other):
        return (isinstance(other, TypeInformation)
                and self.name == other.name)

    def __hash__(self):
        return hash(self.name)


class Types:
    """(ref: Types.java / BasicTypeInfo.java) — the standard type
    instances + composite constructors."""

    LONG = TypeInformation("Long", LongSerializer())
    INT = TypeInformation("Integer", IntSerializer())
    DOUBLE = TypeInformation("Double", DoubleSerializer())
    BOOLEAN = TypeInformation("Boolean", BooleanSerializer())
    STRING = TypeInformation("String", StringSerializer())
    BYTES = TypeInformation("Bytes", BytesSerializer())
    PICKLED = TypeInformation("Pickled", PickleSerializer(),
                              is_basic=False)
    NUMPY = TypeInformation("NumpyArray", NumpyArraySerializer(),
                            is_basic=False)

    @staticmethod
    def TUPLE(*fields: TypeInformation) -> TypeInformation:
        return TypeInformation(
            f"Tuple{len(fields)}<{', '.join(f.name for f in fields)}>",
            TupleSerializer([f.serializer for f in fields]),
            arity=len(fields), is_basic=False)

    @staticmethod
    def LIST(element: TypeInformation) -> TypeInformation:
        return TypeInformation(f"List<{element.name}>",
                               ListSerializer(element.serializer),
                               is_basic=False)

    @staticmethod
    def MAP(key: TypeInformation, value: TypeInformation
            ) -> TypeInformation:
        return TypeInformation(f"Map<{key.name}, {value.name}>",
                               MapSerializer(key.serializer,
                                             value.serializer),
                               is_basic=False)


_BY_TYPE = {
    bool: Types.BOOLEAN,   # before int: bool is an int subclass
    int: Types.LONG,
    float: Types.DOUBLE,
    str: Types.STRING,
    bytes: Types.BYTES,
}


def type_info_of(sample: Any) -> TypeInformation:
    """The extractor (ref: TypeExtractor.createTypeInfo): infer a
    TypeInformation from a SAMPLE VALUE, recursing through composites;
    anything unrecognized falls back to the pickled generic type (the
    GenericTypeInfo/Kryo analogue)."""
    for t, info in _BY_TYPE.items():
        if type(sample) is t:
            return info
    if isinstance(sample, tuple):
        return Types.TUPLE(*(type_info_of(f) for f in sample))
    if isinstance(sample, list) and sample:
        first = type_info_of(sample[0])
        if all(type_info_of(x) == first for x in sample[:8]):
            return Types.LIST(first)
    if isinstance(sample, dict) and sample:
        k, v = next(iter(sample.items()))
        return Types.MAP(type_info_of(k), type_info_of(v))
    if isinstance(sample, np.ndarray):
        return Types.NUMPY
    if isinstance(sample, (np.integer,)):
        return Types.LONG
    if isinstance(sample, (np.floating,)):
        return Types.DOUBLE
    return Types.PICKLED


def extract_type_infos(samples: List[Any]) -> TypeInformation:
    """Extract from several samples, widening to PICKLED on conflict
    (the extractor's common-supertype fallback)."""
    infos = {type_info_of(s) for s in samples}
    return infos.pop() if len(infos) == 1 else Types.PICKLED
