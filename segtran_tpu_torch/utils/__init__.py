from .meters import AverageMeters
from .misc import get_seg_colormap, setup_logging
