from .checkpoint import load_layer, mltps_resumable, save_layer
from .geotiff import read_geotiff, write_geotiff_file
from .overviews import read_overview, write_overviews
from .rdata import read_rdata
from .writers import write_geotiff, write_loadings, write_residuals

__all__ = [
    "load_layer",
    "mltps_resumable",
    "save_layer",
    "read_geotiff",
    "read_overview",
    "read_rdata",
    "write_geotiff",
    "write_geotiff_file",
    "write_loadings",
    "write_overviews",
    "write_residuals",
]
