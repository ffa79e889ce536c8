from .extract import (find_contour, contour_length,  # noqa: F401
                      contour_lengths, contour_area)
from . import breaking  # noqa: F401
from .breaking import df_contours  # noqa: F401
