"""GGUF weight I/O for the port: reader and the block formats this slice loads."""
from .quants import TYPE_BY_ID, TYPE_BY_NAME, QuantSpec, dequantize, type_size
from .reader import GGUFReader, TensorInfo

__all__ = ["TYPE_BY_ID", "TYPE_BY_NAME", "QuantSpec", "dequantize",
           "type_size", "GGUFReader", "TensorInfo"]
