from . import compile_cache
from . import timing
from . import math_utils
from .timing import Timer, timeit, time_blocked, TimingStats, trace, annotate
from .math_utils import (normalize_vector, is_point_in_halfspace,
                         project_point_to_halfspace)
from .compile_cache import enable_compile_cache
