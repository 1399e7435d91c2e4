"""The yardstick's arithmetic: the card's peaks and the least bytes a step
and K1's launches must move.

Peak: NVIDIA's H100 SXM data sheet, HBM3 at 3.35 TB/s.  A share of a
roofline is the least time these bytes take at the peak rate over the
time measured; each input byte is counted read once and each output
byte written once, whatever a kernel reads again.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"float64": 8, "float32": 4}

# the prognostic state per column: 30 BGC tracers, DMS and DMSP, PROT,
# POLY and LIP, and the two 3-D pH warm starts a level; the two surface
# pH warm starts a column
STATE_PER_LEVEL = 30 + 2 + 3 + 2
STATE_PER_COLUMN = 2
# the forcing the step reads under the benchmark's namelist (restoring
# off): T, S and the sediment iron flux a level; dust, shortwave,
# pressure, ice, wind, the two atmospheric CO2s, the surface depth, SST
# and SSS a column
FORCING_PER_LEVEL = 3
FORCING_PER_COLUMN = 10
# the grid: centre, thickness and bottom depth a level, latitude a
# column, and kmax (int32) a column
GRID_PER_LEVEL = 3
GRID_PER_COLUMN = 1
KMAX_BYTES = 4

# K1 (csrc/carbonate_dual.cu), by instance: the dual instance reads 21
# fields a cell and writes 8; the bracket-in instance reads dic, x1 and
# x2 and writes H per lane, and reads ta, pt, sit and the 15 constants
# per shared element (as counted for the kernel table)
K1_DUAL_FIELDS = 21 + 8
K1_BRACKET_LANE_FIELDS = 4
K1_BRACKET_SHARED_FIELDS = 18


def step_bytes(nlev: int, ncol: int, dtype: str) -> int:
    """The least bytes of one coupled step: the state read and written
    once, the forcing and the grid read once."""
    e = ELEMENT_BYTES[dtype]
    per_col = (2 * (STATE_PER_LEVEL * nlev + STATE_PER_COLUMN)
               + FORCING_PER_LEVEL * nlev + FORCING_PER_COLUMN
               + GRID_PER_LEVEL * nlev + GRID_PER_COLUMN)
    return ncol * (per_col * e + KMAX_BYTES)


def k1_dual_bytes(cells: int, dtype: str) -> int:
    """The dual instance's bytes on ``cells`` cells."""
    return K1_DUAL_FIELDS * cells * ELEMENT_BYTES[dtype]


def k1_bracket_bytes(lanes: int, shared: int, dtype: str) -> int:
    """The bracket-in instance's bytes on ``lanes`` lanes that share
    ``shared`` elements of the rest (the surface pair: 2 lanes a column)."""
    return ((K1_BRACKET_LANE_FIELDS * lanes
             + K1_BRACKET_SHARED_FIELDS * shared) * ELEMENT_BYTES[dtype])


def seconds_at_peak(nbytes: float) -> float:
    """The least time ``nbytes`` take at the HBM rate."""
    return nbytes / HBM_BYTES_PER_S
