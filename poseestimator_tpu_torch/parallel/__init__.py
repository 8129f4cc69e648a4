"""parallel: a 1-D device mesh over ``torch.distributed`` and the sharded
programs on it (counterpart of ``poseestimator_tpu/parallel``): the
query-sharded Chamfer, the template-sharded product search, object-sharded
multi-object tracking and batch-sharded detection serving. Every rank calls
a sharded function with the same full inputs and gets the full result
(SPMD); data-parallel training is ``training.Trainer(mesh=)``."""
from .bigcloud import sharded_chamfer
from .mesh import Mesh, launch, make_mesh, replicate, shard_along
from .registration import make_synthetic_search_inputs, sharded_template_search
from .serving import ShardedDetector
from .tracking import sharded_multi_track
