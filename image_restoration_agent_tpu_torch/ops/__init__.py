from .pixel_shuffle import pixel_shuffle, pixel_unshuffle
from .window_attention import (
    window_partition,
    window_reverse,
    relative_position_index,
    shift_attention_mask,
    window_attention,
)
from .conv3x3 import (conv3x3, conv3x3_plain, conv_after_shuffle_weights,
                      compose_conv_weights)
from .restormer_fused import (gdfn_block, gdfn_block_plain, gdfn_weights,
                              mdta_block, mdta_block_plain, mdta_front,
                              mdta_front_plain, mdta_weights,
                              restormer_fused_supported)
from .roll2d import roll2d, roll2d_plain
from .swin_block import (swin_block, swin_block_plain, mlp_block,
                         mlp_block_plain, prepare_swin_params,
                         pad_width_for_strips, strip_chunk_width,
                         swin_attn_block, swin_attn_block_plain, wmsa_block,
                         wmsa_block_plain)

__all__ = [
    "pixel_shuffle", "pixel_unshuffle",
    "window_partition", "window_reverse", "relative_position_index",
    "shift_attention_mask", "window_attention",
    "conv3x3", "conv3x3_plain", "conv_after_shuffle_weights",
    "compose_conv_weights",
    "swin_block", "swin_block_plain", "mlp_block", "mlp_block_plain",
    "prepare_swin_params", "pad_width_for_strips", "strip_chunk_width",
    "swin_attn_block", "swin_attn_block_plain", "wmsa_block",
    "wmsa_block_plain", "roll2d", "roll2d_plain",
    "gdfn_block", "gdfn_block_plain", "gdfn_weights", "mdta_block",
    "mdta_block_plain", "mdta_front", "mdta_front_plain", "mdta_weights",
    "restormer_fused_supported",
]
