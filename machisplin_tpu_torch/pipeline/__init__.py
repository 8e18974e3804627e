from .mltps import LayerResult, MLTPSConfig, mltps, predict_over_stack
from .tiles import TileSet, tiles_create, tiles_id, tiles_merge

__all__ = ["LayerResult", "MLTPSConfig", "TileSet", "mltps", "predict_over_stack", "tiles_create", "tiles_id",
           "tiles_merge"]
