from .flops import count_params, estimate_flops, measure_fps
from .postproc import remove_fragmentary_segs
