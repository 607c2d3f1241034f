"""Multi-device work over the ('data', 'model', 'seq', 'pipe') mesh — port
of ``movae_tpu/parallel/``: process groups, the mesh and ``DataParallel``
(``mesh.py``), hand-written fsdp (``fsdp.py``), tensor parallelism
(``tensor.py``), GPipe over the prior's blocks (``pipeline.py``), the
one interface the trainers call on them (``holder.py``), and
context-parallel attention with sample-parallel generation
(``context.py``; the ring itself is ``ops/ring_attention.py``)."""

from movae_tpu_torch.parallel.mesh import (AXES, DataParallel, Mesh,
                                           active_data_parallel,
                                           init_distributed, make_mesh,
                                           process_count, process_index)

__all__ = ["AXES", "DataParallel", "Mesh", "active_data_parallel",
           "init_distributed", "make_mesh", "process_count",
           "process_index"]
