"""Bytes a step must move and the card's published peaks: the yardstick of
``kernel_roofline``.

A step of the grid-characteristic method reads every node's state and
material stack once and writes its state once, whatever kernels do it:
``2 x ncomp x state bytes + stack fields x stack bytes`` a node (88 B for
the 3D isotropic float32 step on the compact four-field stack). Slabs,
halos and fixups are not counted, so the count is the least work of the
step and its share of the roofline cannot pass 100% unless the time leaves
work out.
"""

from __future__ import annotations

import math
from typing import Dict

#: the H100 SXM's published HBM3 rate, bytes a second (NVIDIA's data
#: sheet, at its 700 W power limit)
HBM_BYTES_S = 3.35e12

_NCOMP = {"elastic3d": 9, "elastic2d": 5}
_TYPE_BYTES = {"float32": 4, "bfloat16": 2, "float64": 8}
#: material fields of each stack the fused kernels read
_STACK_FIELDS = {"compact": 4}


def bytes_per_node(config: Dict) -> int:
    state = _TYPE_BYTES[config["dtype"]]
    stack = _TYPE_BYTES[config.get("stack_dtype", config["dtype"])]
    return (2 * _NCOMP[config["model"]] * state
            + _STACK_FIELDS[config["material_stack"]] * stack)


def bytes_per_step_card(config: Dict) -> int:
    """Bytes of one step on the busiest card: every body's nodes, split
    evenly over the mesh's cards."""
    cards = math.prod(config["mesh"]) if config.get("mesh") else 1
    nodes = sum(math.prod(b["shape"]) for b in config["bodies"].values())
    return bytes_per_node(config) * -(-nodes // cards)


def least_step_s(config: Dict) -> float:
    """The least time of one step on the busiest card, at the peak rate."""
    return bytes_per_step_card(config) / HBM_BYTES_S
