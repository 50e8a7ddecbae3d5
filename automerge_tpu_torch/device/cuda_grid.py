"""What the grid variants of the RGA-order and edit-stream kernels share
on the Python side: the limits of one cooperative launch, which
``csrc/grid.cuh`` sets (``chip_smoke.py`` holds the two to each other),
and the lookup of a measured crossover table. Pure functions of the
shape: nothing here needs a card.
"""

# the most job rows a grid launch takes (grid.cuh's kGridMaxRows)
GRID_MAX_ROWS = 8192
# the most slots, rows times row width, a grid launch takes (grid.cuh's
# kGridMaxSlots: every slot index stays an int)
GRID_MAX_SLOTS = (2**31 - 1) // 8


def band_rows(bands, m):
    """The most rows at width ``m`` that a crossover table ``bands``
    (pairs of an upper width bound, None for the open last band, and a
    row count) sends to the grid variant."""
    for bound, rows in bands:
        if bound is None or m <= bound:
            return rows
    raise AssertionError('a crossover table has no open last band')


def fits(K, slots):
    """Whether one grid launch takes ``K`` rows of ``slots`` slots in
    all."""
    return K <= GRID_MAX_ROWS and slots <= GRID_MAX_SLOTS


def check(K, slots):
    """Raise ``ValueError`` unless one grid launch takes ``K`` rows of
    ``slots`` slots in all."""
    if not fits(K, slots):
        raise ValueError(
            f'a grid launch takes at most {GRID_MAX_ROWS} rows and '
            f'{GRID_MAX_SLOTS} slots, not {K} rows and {slots} slots')
