"""Axis-layout helpers: map a layout string such as "NTHWC" to axis indices."""
from typing import Dict


def parse_layout_shape(layout: str) -> Dict[str, int]:
    """Map a layout string like "NTHWC" to axis indices (-1 if absent)."""
    return {
        "batch_axis": layout.find("N"),
        "t_axis": layout.find("T"),
        "h_axis": layout.find("H"),
        "w_axis": layout.find("W"),
        "c_axis": layout.find("C"),
    }

