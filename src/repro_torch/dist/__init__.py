"""repro_torch.dist — distributed serving (port of ``repro.dist``'s
serving side), over ``torch.distributed``:

* ``topology`` — ``Topology`` (one worker's place in the fleet, the
  process-group handshake, backend and device per rank),
  ``candidate_shards`` (one shard per rank over a power-of-two prefix) and
  the collective-aware bucket planner (``bucket_for``, ``plan_buckets``);
* ``sharding`` — ``candidate_pspecs`` (stage 2's argument placements) and
  ``gather_rows``, the closing score all-gather;
* ``compress`` — int8 wire formats (``quantize_int8``,
  ``compressed_psum`` with error feedback, ``compressed_all_gather``);
* ``runner`` — the multi-process SPMD serving runner
  (``python -m repro_torch.dist.runner``).
"""
from repro_torch.dist.compress import (compressed_all_gather,  # noqa: F401
                                       compressed_psum, dequantize_int8,
                                       quantize_int8)
from repro_torch.dist.sharding import candidate_pspecs  # noqa: F401
from repro_torch.dist.topology import (Topology, bucket_for,  # noqa: F401
                                       candidate_shards, plan_buckets)
