"""Multi-device sharding: device meshes and distributed PHY pipelines.

The batched replacement for the reference's process/thread concurrency
(SURVEY.md section 2.6): subframe batches ride a data-parallel mesh axis
(the analog of the reference's worker pipeline, thread_pool.h:46),
component carriers ride a carrier axis (the analog of one-process-per-cell,
radio_multi.cc), and the turbo decoder's trellis can be sequence-sharded
across devices with boundary-metric exchange via lax.ppermute — the
collective analog of turbodecoder_win.h's lane-overlap scheme.
"""

from .dist import init_distributed, make_global_mesh
from .mesh import make_mesh, shard_batch
from .turbo_sp import sp_turbo_decode, sp_turbo_decode_nii

__all__ = ["init_distributed", "make_global_mesh", "make_mesh",
           "shard_batch", "sp_turbo_decode", "sp_turbo_decode_nii"]
