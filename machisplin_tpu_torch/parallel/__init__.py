from .sharded import batched_tile_solve, batched_tile_tps, make_mesh, pack_tiles, tile_tps_predict

__all__ = ["batched_tile_solve", "batched_tile_tps", "make_mesh", "pack_tiles", "tile_tps_predict"]
