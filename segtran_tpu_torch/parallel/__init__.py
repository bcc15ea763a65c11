"""Multi-GPU training and inference on ``torch.distributed`` (counterpart of
``segtran_tpu/parallel/``): one process per GPU, launched by ``torchrun``.
``mesh`` and ``multihost`` set up the process group and its device mesh;
``tensor_parallel`` shards optimizer state and master weights;
``expert``, ``context_parallel`` and ``pipeline`` are the mode-, token- and
layer-sharded primitives; ``spatial`` shards a whole-volume forward's
output."""
from .mesh import make_mesh, replicate_to_mesh, shard_train_step
