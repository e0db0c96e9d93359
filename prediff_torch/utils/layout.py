"""Axis-layout helpers: map a layout string such as "NTHWC" to axis indices."""
from typing import Dict, Optional, Tuple


def parse_layout_shape(layout: str) -> Dict[str, int]:
    """Map a layout string like "NTHWC" to axis indices (-1 if absent)."""
    return {
        "batch_axis": layout.find("N"),
        "t_axis": layout.find("T"),
        "h_axis": layout.find("H"),
        "w_axis": layout.find("W"),
        "c_axis": layout.find("C"),
    }



def layout_to_in_out_slice(layout: str, in_len: int,
                           out_len: Optional[int] = None) -> Tuple[tuple, tuple]:
    """Index tuples selecting the context (the first ``in_len`` frames) and
    the target (the next ``out_len``, or all the rest) along the T axis of
    ``layout``."""
    t_axis = layout.find("T")
    in_slice = [slice(None)] * len(layout)
    out_slice = [slice(None)] * len(layout)
    in_slice[t_axis] = slice(None, in_len)
    out_slice[t_axis] = slice(in_len, None if out_len is None else in_len + out_len)
    return tuple(in_slice), tuple(out_slice)
