"""GGUF weight I/O for the port: reader, writer and the block formats it loads."""
from .quants import TYPE_BY_ID, TYPE_BY_NAME, QuantSpec, dequantize, type_size
from .reader import GGUFReader, TensorInfo
from .writer import GGUFWriter, pack_zip

__all__ = ["TYPE_BY_ID", "TYPE_BY_NAME", "QuantSpec", "dequantize",
           "type_size", "GGUFReader", "TensorInfo", "GGUFWriter", "pack_zip"]
