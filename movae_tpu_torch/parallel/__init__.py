"""Multi-device work over the ``data`` mesh axis — port of the data half of
``movae_tpu/parallel/``: process groups, the mesh and ``DataParallel``
(``mesh.py``), hand-written fsdp (``fsdp.py``) and sample-parallel
generation (``context.py``). Tensor, pipeline and context parallelism are
ROADMAP.md Queue 1 item 13's remaining sub-items."""

from movae_tpu_torch.parallel.mesh import (AXES, DataParallel, Mesh,
                                           active_data_parallel,
                                           init_distributed, make_mesh,
                                           process_count, process_index)

__all__ = ["AXES", "DataParallel", "Mesh", "active_data_parallel",
           "init_distributed", "make_mesh", "process_count",
           "process_index"]
