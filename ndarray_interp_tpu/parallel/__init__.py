from ..ops.gridshard import (
    pack_interpnd_grid_shards,
    place_grid_shards,
    shard_interp2d_grid,
    shard_interpnd_grid,
    sharded_grid_eval,
)
from ..ops.knotshard import (
    pack_knot_shards,
    place_knot_shards,
    shard_interp1d_knots,
    sharded_knot_eval,
)
from .sharding import (
    make_mesh,
    shard_interp1d,
    shard_interp2d,
    shard_queries,
    sharded_eval_1d,
    sharded_eval_2d,
)

__all__ = [
    "make_mesh",
    "pack_interpnd_grid_shards",
    "pack_knot_shards",
    "place_grid_shards",
    "place_knot_shards",
    "shard_interp1d",
    "shard_interp1d_knots",
    "shard_interp2d",
    "shard_interp2d_grid",
    "shard_interpnd_grid",
    "shard_queries",
    "sharded_eval_1d",
    "sharded_eval_2d",
    "sharded_grid_eval",
    "sharded_knot_eval",
]
