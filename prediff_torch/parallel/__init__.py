"""Several ranks of ``torch.distributed`` as the JAX package's data mesh
(``prediff_tpu/parallel``)."""
from .mesh import (DataMesh, all_reduce_mean, all_reduce_sum, all_reduce_sum_grad, batch_rows,
                   gather_batch, init_distributed, local_batch_slice, make_2d_mesh,
                   make_data_mesh, make_mesh, replicate, replicate_, shard_batch)
