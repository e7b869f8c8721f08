"""The traffic generator: read sets made on the device from a seed
(reads.py)."""

from portbench.gen.reads import (  # noqa: F401
    Dataset,
    Features,
    Layout,
    draw_layout,
    make_read_set,
    make_rows,
    truth_pairs,
)
