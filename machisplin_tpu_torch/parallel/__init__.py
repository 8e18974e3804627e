from .tiles import batched_tile_solve, pack_tiles

__all__ = ["batched_tile_solve", "pack_tiles"]
