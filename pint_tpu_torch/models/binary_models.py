"""Binary-model registry: BINARY par value -> component class name.

Reference: the binary-model dispatch in `ModelBuilder.choose_model`
(`src/pint/models/model_builder.py:969` +
`pulsar_binary.py:36`).
"""

from __future__ import annotations

from pint_tpu_torch.exceptions import UnknownBinaryModel

#: BINARY value (upper) -> registered component class name
BINARY_COMPONENTS = {
    "ELL1": "BinaryELL1",
    "ELL1H": "BinaryELL1H",
    "ELL1K": "BinaryELL1k",
    "BT": "BinaryBT",
    "DD": "BinaryDD",
    "DDS": "BinaryDDS",
    "DDH": "BinaryDDH",
    "DDK": "BinaryDDK",
    "DDGR": "BinaryDDGR",
    "BT_PIECEWISE": "BinaryBTPiecewise",
}


def component_for(binary: str) -> str:
    try:
        name = BINARY_COMPONENTS[binary.upper()]
    except KeyError:
        raise UnknownBinaryModel(
            f"binary model {binary!r} is not implemented "
            f"(available: {sorted(BINARY_COMPONENTS)})")
    from pint_tpu_torch.models.timing_model import Component

    if name not in Component.component_types:
        raise NotImplementedError(
            f"binary model {binary!r} ({name}) is not ported to "
            "pint_tpu_torch yet")
    return name
