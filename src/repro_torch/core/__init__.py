from repro_torch.core.gca import Color, GCAResult, run_gca  # noqa: F401
from repro_torch.core.mari import (  # noqa: F401
    apply_mari,
    convert_params,
    mari_rewrite,
)
from repro_torch.core.split import TwoStageSplit, split_two_stage  # noqa: F401
