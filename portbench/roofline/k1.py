"""The work of kernel K1 (the thin-plate spline over a grid's cells).

For every (cell, knot) pair: two subtractions, three operations for r^2,
a max, a log and a multiply make phi (8), then one multiply-add (2) a
response.  Each cell's value is written once a response; the knots'
coordinates and coefficients are read once.  The counts follow from the
shapes of the inputs alone: phi is counted once a pair whatever number of
launches the kernel splits the responses into."""

from .peaks import bound_s


def work(cells: int, knots: int, responses: int) -> tuple[int, int]:
    """(operations, bytes) of one surface of ``responses`` responses from
    ``knots`` knots over ``cells`` cells, in float32."""
    ops = cells * knots * (8 + 2 * responses)
    nbytes = 4 * (responses * cells + 2 * knots + responses * knots + 3 * responses)
    return ops, nbytes


def bound(cells: int, knots: int, responses: int) -> tuple[float, str]:
    """K1's least seconds for that surface on the card, and its bound."""
    return bound_s(*work(cells, knots, responses))
