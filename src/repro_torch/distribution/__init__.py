"""Distribution on a single controller: the port's ``Mesh``, rank-ordered
collectives over per-position lists, the parameter layout
(``sharding.py``) and the activation constraints (``act_sharding.py``).

The reference is SPMD: ``jax.shard_map`` and GSPMD run one program on
every device of a mesh.  The port is one Python process driving every
position of a mesh in turn (see ``mesh.py``): a sharded op splits its
tensors by a spec, runs each position's shard body in rank order on that
position's device, and combines the results with the collectives of
``collectives.py``.  No ``torch.distributed`` process group is created,
and a mesh with more positions than cards reuses the cards round-robin.
"""
from repro_torch.distribution.mesh import Mesh

__all__ = ["Mesh"]
