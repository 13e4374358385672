"""The paper's primary contribution: GCA detection, MaRI rewrite, reorg."""
from repro_torch.core.gca import Color, GCAResult, run_gca  # noqa: F401
from repro_torch.core.mari import (  # noqa: F401
    apply_mari,
    convert_params,
    MaRIConversion,
    mari_flops,
    mari_rewrite,
    matmul_mari,
    matmul_mari_fragmented,
    vanilla_flops,
)
from repro_torch.core.split import TwoStageSplit, split_two_stage  # noqa: F401
from repro_torch.core.partition import WeightPartition  # noqa: F401
from repro_torch.core.reorg import (  # noqa: F401
    ReorgPlan,
    convert_params_reorg,
    reorganize,
)
from repro_torch.core.fx_gca import FxGCAReport, detect_in_fx  # noqa: F401
