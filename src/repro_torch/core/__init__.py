"""NxFP numeric core on torch: formats, arithmetic codec, packing, QTensor."""
from .formats import BlockFormat, ElementFormat, get_format, ELEMENT_FORMATS
from .levels import LevelTable, level_table
from .pack import (byte_fold, bytes_per_block, pack_codes,
                   pack_codes_scatter, pack_layout, pack_tile, unpack_codes)
# ``quantize`` and ``dequantize`` stay in ``core.quantize``: a package
# attribute of that name would hide the submodule
from .quantize import (arith_encode_blocks, dequantize_blocks, fake_quant,
                       from_blocks, meta_fields, quantize_blocks,
                       quantize_blocks_arith, quantize_blocks_gatherfree,
                       to_blocks)
from .qtensor import (QTensor, QuantPolicy, dense_like, direct_cast_tree,
                      tree_footprint_bytes)

__all__ = [
    "BlockFormat", "ElementFormat", "get_format", "ELEMENT_FORMATS",
    "LevelTable", "level_table",
    "bytes_per_block", "pack_codes", "pack_codes_scatter", "unpack_codes",
    "pack_tile", "pack_layout", "byte_fold",
    "arith_encode_blocks", "quantize_blocks_arith", "quantize_blocks",
    "quantize_blocks_gatherfree", "dequantize_blocks", "fake_quant",
    "to_blocks", "from_blocks", "meta_fields",
    "QTensor", "QuantPolicy", "direct_cast_tree", "dense_like",
    "tree_footprint_bytes",
]
