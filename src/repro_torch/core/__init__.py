"""NxFP numeric core on torch: formats, arithmetic codec, packing, QTensor."""
from .formats import BlockFormat, ElementFormat, get_format, ELEMENT_FORMATS
from .levels import LevelTable, level_table
from .pack import bytes_per_block, pack_codes, pack_codes_scatter, unpack_codes
from .quantize import (arith_encode_blocks, dequantize_blocks, from_blocks,
                       meta_fields, quantize_blocks, quantize_blocks_arith,
                       to_blocks)
from .qtensor import (QTensor, QuantPolicy, direct_cast_tree,
                      tree_footprint_bytes)

__all__ = [
    "BlockFormat", "ElementFormat", "get_format", "ELEMENT_FORMATS",
    "LevelTable", "level_table",
    "bytes_per_block", "pack_codes", "pack_codes_scatter", "unpack_codes",
    "arith_encode_blocks", "quantize_blocks_arith", "quantize_blocks",
    "dequantize_blocks",
    "to_blocks", "from_blocks", "meta_fields",
    "QTensor", "QuantPolicy", "direct_cast_tree", "tree_footprint_bytes",
]
