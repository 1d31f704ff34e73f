from .collectives import Mesh  # noqa: F401
from .sharding import make_mesh, shard_model, sharded_fraction  # noqa: F401
