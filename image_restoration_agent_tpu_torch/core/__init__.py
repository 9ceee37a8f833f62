from .pad import pad_to_multiple, unpad
from .tiling import TilePlan, plan_tiles, extract_tiles, blend_tiles, tiled_apply
from .io import load_image, save_image, decode_image, encode_png
from .color import rgb_to_hsv, hsv_to_rgb

__all__ = [
    "pad_to_multiple", "unpad",
    "TilePlan", "plan_tiles", "extract_tiles", "blend_tiles", "tiled_apply",
    "load_image", "save_image", "decode_image", "encode_png",
    "rgb_to_hsv", "hsv_to_rgb",
]
