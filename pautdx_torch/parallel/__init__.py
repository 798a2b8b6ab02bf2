"""Parallelism layer (an alias of ``pautdx_torch.mesh``).

Counterpart of ``pautdx/parallel/__init__.py``: data parallelism over a
``dp`` mesh is the framework's scaling story; the mesh and placement
helpers live in ``pautdx_torch.mesh``, and this package is the
conventional import point.
"""

from pautdx_torch.mesh import (  # noqa: F401
    batch_sharding, make_mesh, pad_to_multiple, replicated, shard_batch,
)
