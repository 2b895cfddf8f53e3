"""Keras HDF5 model import and export over the port's own HDF5 reader and
writer (``hdf5.py``; no h5py), and the Keras backend server."""

from .importer import KerasModelImport
from .layers import KerasLayerError, convert_layer, convert_vertex
from .server import KerasBackendServer

__all__ = ["KerasModelImport", "KerasLayerError", "convert_layer",
           "convert_vertex", "KerasBackendServer"]
